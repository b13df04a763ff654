"""A data-parallel forward in one process over an ordered device list.

What GSPMD makes of the JAX package's jitted train step on a batch sharded
over a ``('data',)`` mesh: each device runs the forward of its share of
the global batch, and every train-mode BatchNorm normalizes with the
statistics of the global batch. The port drives the shares from one
process (``parallel.mesh``), a Python thread a share (:class:`ShareThreads`),
and sums the statistics across the shares at each BatchNorm
(:class:`GlobalBatchStats`, hung on ``BatchNorm.reduce_stats``). The sums
are reduced on the first device in mesh order and sent back with
differentiable copies, so autograd carries the backward across the
devices and no collective is needed there.

The shares take turns (:class:`Turns`): one runs at a time, in mesh order,
until its next BatchNorm or its end, and hands the turn to the next. The
interpreter lock lets one thread run Python at a time anyway; taking turns
issues the shares' work in the same order every step, with no two share
threads contending for the lock. The card runs what one share launched
while the next issues its own.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import weakref
from functools import partial

import torch

TURN_TIMEOUT_S = 300.0  # a share waits this long for its turn


class ShareAborted(RuntimeError):
    """Raised in a share waiting for its turn when another share failed."""


class Turns:
    """Round-robin turns of ``n`` shares in mesh order, share 0 first. A
    share calls :meth:`wait` before it runs and :meth:`pass_on` when it
    stops (``finished`` at its end). Only the share that holds the turn
    runs, so only it reads or changes the order of the shares left."""

    def __init__(self, n: int, timeout: float = TURN_TIMEOUT_S):
        self.go = [threading.Event() for _ in range(n)]
        self.left = list(range(n))  # shares not finished, in mesh order
        self.timeout = timeout
        self.aborted = False
        self.go[0].set()

    def wait(self, share: int) -> None:
        if not self.go[share].wait(self.timeout):
            raise TimeoutError(f"share {share} waited {self.timeout} s for its turn")
        self.go[share].clear()
        if self.aborted:
            raise ShareAborted("another share failed")

    def pass_on(self, share: int, finished: bool = False) -> None:
        i = self.left.index(share)
        after = self.left[(i + 1) % len(self.left)]
        if finished:
            self.left.remove(share)
        if self.left:
            self.go[after].set()

    def abort(self) -> None:
        """Wake every share, to raise :class:`ShareAborted`."""
        self.aborted = True
        for go in self.go:
            go.set()


class GlobalBatchStats:
    """One forward's cross-share BatchNorm reduction over ``devices``.

    Share ``i`` calls :meth:`stats` at every train-mode BatchNorm it runs,
    with its float activations (N, C, H, W). It puts its per-channel
    ``sum(x)`` and ``sum(x * x)`` on ``devices[0]`` and hands the turn on;
    the last share folds them in mesh order into the global sums. When its
    turn comes back, every share has put its sums and the last has folded
    them, and each share forms the global mean and flax's clamped biased
    variance from the same tensors (the same bits on every share). The
    slots alternate between two sets from one call to the next: a share
    writes a set again only after every share has read it.
    """

    def __init__(self, devices, turns: Turns):
        n = len(devices)
        self.root = devices[0]
        self.turns = turns
        self.slots = ([None] * n, [None] * n)
        self.totals = [None, None]
        self.calls = [0] * n

    def stats(self, share: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, var) of the global batch, on ``x``'s device."""
        dims = (0, 2, 3)
        parity = self.calls[share] % 2
        self.calls[share] += 1
        slots = self.slots[parity]
        local = torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims)])
        slots[share] = local.to(self.root), x.numel() // x.shape[1]
        if share == len(slots) - 1:
            total = slots[0][0]
            for part, _ in slots[1:]:
                total = total + part
            self.totals[parity] = total, sum(c for _, c in slots)
        self.turns.pass_on(share)
        self.turns.wait(share)
        total, count = self.totals[parity]
        total = total.to(x.device)
        mean = total[0] / count
        return mean, torch.clamp(total[1] / count - mean * mean, min=0.0)


class ShareThreads:
    """A daemon thread a device of ``devices``, kept while this object lives.
    :meth:`run` calls ``fn(i)`` on thread ``i``, so thread-local state of
    the libraries under a share (such as cached convolution plans) survives
    from one call to the next: with threads made anew each step, a float32
    lite0 step over ``[cuda:0] * 2`` took 4.49x the one-device step's time
    on an H100, with these 2.60x (``chip_smoke.py`` phase 18). The threads
    end when this object is collected."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.jobs = [queue.SimpleQueue() for _ in self.devices]
        for i, jobs in enumerate(self.jobs):
            threading.Thread(target=_serve, args=(jobs,), name=f"share-{i}", daemon=True).start()
        weakref.finalize(self, _stop, self.jobs)

    def run(self, fn, turns: Turns) -> list:
        """``[fn(i) for i in range(len(devices))]``, each call on its thread
        with ``devices[i]`` the current CUDA device and the caller's grad
        mode, taking ``turns``. If a call raises, the others are aborted,
        every call is waited for, and the first error that is not an abort
        is raised again, noting its share."""
        n = len(self.devices)
        results, errors = [None] * n, [None] * n
        done = [threading.Event() for _ in range(n)]
        grad = torch.is_grad_enabled()

        def job(i: int) -> None:
            dev = self.devices[i]
            where = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            try:
                turns.wait(i)
                with torch.set_grad_enabled(grad), where:
                    results[i] = fn(i)
                turns.pass_on(i, finished=True)
            except BaseException as e:  # noqa: BLE001 - handed to the caller's thread below
                errors[i] = e
                turns.abort()
            finally:
                done[i].set()

        for i, jobs in enumerate(self.jobs):
            jobs.put(partial(job, i))
        for event in done:
            event.wait()
        failed = [(i, e) for i, e in enumerate(errors) if e is not None]
        if failed:
            i, error = next(((i, e) for i, e in failed if not isinstance(e, ShareAborted)),
                            failed[0])
            error.add_note(f"in share {i} of {n}, on {self.devices[i]}")
            raise error
        return results


def _serve(jobs: queue.SimpleQueue) -> None:
    while True:
        job = jobs.get()
        if job is None:
            return
        job()
        del job  # the last call's tensors go with it


def _stop(jobs: list) -> None:
    for q in jobs:
        q.put(None)
