"""Ranks as threads of one process: a stand-in exchanger for
`vspbfr_tpu_torch.parallel.Spatial`, for the CPU tests of the H-sharded
stages (`tests/test_torch_sharding2d.py`, `tests/test_torch_packed_mesh.py`,
`tests/test_torch_packed_mesh_grads.py`). No process group: the threads
meet at a barrier."""

import threading
import types

import torch

from vspbfr_tpu_torch.parallel import Spatial

RANK_TIMEOUT = 240        # seconds the thread ranks may take


class ThreadRows:
    """A stand-in exchanger: rank `rank` of `hub.n` threads of this process;
    `all_gather` meets the others at a barrier."""

    def __init__(self, hub, rank):
        self.hub, self.rank, self.size = hub, rank, hub.n

    def all_gather(self, t):
        hub = self.hub
        hub.slots[self.rank] = t
        hub.barrier.wait()
        out = list(hub.slots)
        hub.barrier.wait()
        return out

    def all_reduce(self, t):
        """The sum over the ranks, in rank order (the same bits on every
        rank)."""
        parts = self.all_gather(t)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out


def run_threads(n, fn, grad=False):
    """fn(Spatial) on n thread ranks (under no_grad unless `grad`); their
    results in rank order."""
    hub = types.SimpleNamespace(n=n, slots=[None] * n,
                                barrier=threading.Barrier(n, timeout=120))
    out, errors = [None] * n, []

    def go(r):
        try:
            with torch.set_grad_enabled(grad):
                out[r] = fn(Spatial(ThreadRows(hub, r)))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=go, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=RANK_TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out
