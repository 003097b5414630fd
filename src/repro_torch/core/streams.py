"""Hand-off of device tensors between threads that run on their own CUDA
streams (``ThreadedShadowRunner``).

Each thread of the threaded runner does its device work inside
``torch.cuda.stream(own_stream)``, and kernels launch on the current stream,
so the threads overlap on the card instead of serializing on one stream.
The price is that nothing orders one thread's writes before another
thread's reads. The discipline, used for every tensor one thread produces
and another reads:

* the producer ``publish``es the value (a tensor or a tree of tensors): it
  records a CUDA event on its stream after its last write and hands out the
  value together with that event;
* the reader ``consume``s it: its current stream waits on the event before
  the first read, and every leaf is ``record_stream``-ed on the reader's
  stream, so the caching allocator does not hand the memory to a new tensor
  of the producer's stream while the reader's stream may still read it.

On the CPU both are no-ops: a CPU value is complete when the call that made
it returns.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import tree as T


@dataclass(frozen=True)
class Published:
    """A value handed from one stream to another: ``value`` is complete on
    the device once ``event`` (None on the CPU) has completed."""

    value: Any
    event: Optional[torch.cuda.Event]


def new_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on(stream: Optional[torch.cuda.Stream]):
    """Context that makes ``stream`` the current one (nothing on the CPU)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def record(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event on the current stream after the work issued so far."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def wait(event: Optional[torch.cuda.Event]) -> None:
    """The current stream waits for ``event`` (nothing for None)."""
    if event is not None:
        torch.cuda.current_stream().wait_event(event)


def publish(value: Any) -> Published:
    """Wrap ``value`` with a fresh event on the current stream (values made
    together can share one: ``Published(value, record(device))``)."""
    return Published(value, record(T.leaves(value)[0].device))


def consume(pub: Published) -> Any:
    """The published value, safe to read on the current stream."""
    if pub.event is None:
        return pub.value
    wait(pub.event)
    stream = torch.cuda.current_stream()
    for leaf in T.leaves(pub.value):
        if isinstance(leaf, torch.Tensor):  # a state may hold host values (a counter)
            leaf.record_stream(stream)
    return pub.value
