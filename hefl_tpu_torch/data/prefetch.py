"""Double-buffered host-to-device staging of a round's federated arrays.

Counterpart of `hefl_tpu.data.prefetch`. A round reads the federated
arrays (xs, ys) from the device; `RoundPrefetcher` holds them there as a
ring of at most two copies:

  * `prefetch(*arrays, rows=)` starts the copy of the NEXT round's arrays
    while the current round runs: on a card, from pinned host memory,
    `non_blocking` on a side stream, with an event recorded after it.
  * `get(*arrays, rows=)` returns the device copies for the CURRENT round:
    the staged ones when they match, else a copy made now. On a card the
    current stream waits on the copy's event before anything reads it.
    Promoting the staged copy retires the previous round's: the ring frees
    the storage of the copies it made itself (a tensor the caller passed
    in already on the device is handed through and never freed), so at
    most two copies are resident.
  * Identity short-circuit: the same host arrays (and rows) every round
    keep ONE device copy, and both calls return at once.

`rows` (client indices) stages only those clients' rows, `arrays[i][rows]`:
on the client mesh a rank holds only the rows it trains (its block of the
padded registry, `fl.fedavg.client_block`, or of a streaming round's
cohort bucket, `fl.stream.round_rows`), not the whole arrays.

Matching is by host-array identity (`id`) and the rows, not by content:
the ring moves bytes, it does not compare values.
"""

from __future__ import annotations

import numpy as np
import torch


def _key(arrays, rows) -> tuple:
    return tuple(id(a) for a in arrays), None if rows is None else tuple(
        int(r) for r in np.asarray(rows).reshape(-1))


class RoundPrefetcher:
    """The two-entry ring of a round's device arrays on `device` (see the
    module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cur = self._next = None        # (buffers, owned flags, ready event)
        self._cur_key = self._next_key = None
        self._stream = None

    def _put(self, arrays, rows) -> tuple:
        """Copy `arrays` (their `rows`, when given) to the device -> (buffers,
        owned, event). A tensor already on the device with no rows to pick
        is handed through, not owned."""
        cuda = self.device.type == "cuda"
        bufs, owned, copies = [], [], []
        for a in arrays:
            if isinstance(a, torch.Tensor) and a.device == self.device and rows is None:
                bufs.append(a)
                owned.append(False)
                continue
            host = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
            if rows is not None:
                host = host[torch.as_tensor(np.asarray(rows, dtype=np.int64),
                                            device=host.device)]
            if not cuda:
                # A copy even host to host: the ring frees what it owns, never
                # the caller's memory (a tensor from numpy shares the array's).
                bufs.append(host.to(self.device, copy=rows is None))
            else:
                # Allocated on the current stream, so the memory returns to
                # its pool and not to the side stream's, which nothing else
                # allocates from.
                bufs.append(torch.empty(host.shape, dtype=host.dtype, device=self.device))
                copies.append((bufs[-1], host.pin_memory() if host.device.type == "cpu"
                               else host))
            owned.append(True)
        if not cuda:
            return tuple(bufs), tuple(owned), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        # The side stream first waits for the current one: for the work the
        # recycled memory may still hold, and for the fill that `empty`
        # queues there under deterministic algorithms.
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            for buf, host in copies:
                buf.copy_(host, non_blocking=True)
                buf.record_stream(self._stream)
        event = torch.cuda.Event()
        event.record(self._stream)
        return tuple(bufs), tuple(owned), event

    def _ready(self, entry) -> tuple:
        """The entry's buffers, readable on the current stream: it waits on
        the copy's event, and each copied buffer is marked in use there so
        the allocator does not hand its memory out before that stream is
        done with it."""
        bufs, owned, event = entry
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for b, own in zip(bufs, owned):
                if own:
                    b.record_stream(current)
        return bufs

    @staticmethod
    def _retire(entry) -> None:
        """Free the storage of the buffers this ring copied (the analog of
        the JAX ring's `delete()`: the tensor object stays, its memory goes)."""
        if entry is None:
            return
        for b, own in zip(entry[0], entry[1]):
            if own:
                b.untyped_storage().resize_(0)

    def prefetch(self, *arrays, rows=None) -> None:
        """Begin the copy of the next round's arrays (a no-op when they are
        already the current or the staged ones)."""
        key = _key(arrays, rows)
        if key in (self._cur_key, self._next_key):
            return
        self._retire(self._next)              # superseded before use
        self._next, self._next_key = self._put(arrays, rows), key

    def get(self, *arrays, rows=None) -> tuple:
        """Device buffers of this round's arrays (the staged ones if they
        match, else copied now), readable on the current stream. Retires the
        previous round's buffers when it changes round."""
        key = _key(arrays, rows)
        if key == self._cur_key:
            return self._cur[0]
        stale = self._cur
        if key == self._next_key:
            self._cur, self._cur_key = self._next, self._next_key
            self._next = self._next_key = None
        else:
            self._cur, self._cur_key = self._put(arrays, rows), key
        self._retire(stale)
        return self._ready(self._cur)


__all__ = ["RoundPrefetcher"]
