"""Device mesh of the batch entry points (port of
bayes_drt_tpu/parallel/mesh.py).

The JAX package shards the spectra axis of a batch over a ``jax.sharding
.Mesh`` with axes ('spectra', 'chains'): spectra are independent, so no
fit needs a collective and the devices only meet at the gather. The port
does the same with host threads: ``make_mesh`` lays devices out in a
(n // chains_axis, chains_axis) array, the batch splits into contiguous
row ranges along 'spectra' (one range a mesh row), and ``run_shards``
runs each range through the same single-device code on its device, one
host thread a device, and returns the results in row order. The
devices of a mesh row's 'chains' axis hold replicas: the range computes
once, and the layout lists every replica with the range, as JAX's
``addressable_shards`` list a replicated shard.

On the CPU (``device='cpu'``) a mesh holds ``n_devices`` virtual shards
of the one host, the counterpart of the virtual 8-device CPU mesh the
JAX package's tests run on: they prove the split, not a speed-up.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import profiling, progcache


class Shard(NamedTuple):
    """One mesh row's rows [start, stop) of a batch on ``device``.
    ``position`` is the mesh row; ``tag`` keys the shard's progcache
    entries apart from the other shards' where several shards share one
    device (the CPU's virtual shards), else None."""
    device: torch.device
    start: int
    stop: int
    position: int
    tag: Optional[int]


class DeviceMesh:
    """A (n // chains_axis, chains_axis) array of torch devices with the
    axis names ('spectra', 'chains') and each device's index (its CUDA
    ordinal, or its virtual shard number on the CPU)."""

    axis_names = ("spectra", "chains")

    def __init__(self, devices, ids):
        self.devices = devices
        self.ids = ids
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The first device, where a fit's batch-wide work runs (its
        setup, the inits it draws for the whole batch, the escalation
        refit)."""
        return self.devices[0, 0]

    def __repr__(self):
        return (f"DeviceMesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.ravel()]})")

    def ranges(self, b: int):
        """The contiguous [start, stop) row ranges of a b-row batch, one
        per mesh row, as even as b allows (the first b % rows ranges one
        row longer)."""
        n_rows = self.devices.shape[0]
        edges = np.concatenate([[0], np.cumsum(
            [b // n_rows + (i < b % n_rows) for i in range(n_rows)])])
        return [(int(edges[i]), int(edges[i + 1])) for i in range(n_rows)]

    def shards(self, b: int):
        """The shards of a b-row batch: mesh row i's range on its first
        device."""
        lead_devs = [self.devices[i, 0] for i in range(self.devices.shape[0])]
        shared = len({str(d) for d in lead_devs}) < len(lead_devs)
        return [Shard(lead_devs[i], lo, hi, i, i if shared else None)
                for i, (lo, hi) in enumerate(self.ranges(b))]

    def layout(self, b: int):
        """``diagnostics['shard_layout']``: sorted (device index, start,
        stop) of every device, replicas along 'chains' with their row's
        range."""
        return tuple(sorted(
            (int(self.ids[i, j]), lo, hi)
            for i, (lo, hi) in enumerate(self.ranges(b))
            for j in range(self.devices.shape[1])))


def make_mesh(n_devices: Optional[int] = None, chains_axis: int = 1,
              device=None) -> DeviceMesh:
    """Mesh with axes ('spectra', 'chains') over ``n_devices`` devices
    (default all): ``chains_axis`` devices along 'chains' (default 1:
    every device takes its own spectra; the chains of a spectrum run as
    rows of one device, usually the right call since B >> chains).

    ``device``: 'cuda' (the default) takes the first ``n_devices`` of
    ``torch.cuda.device_count()`` cards and raises when more are asked
    for than exist; 'cpu' gives ``n_devices`` (default 1) virtual shards
    of the host. A count not divisible by ``chains_axis`` raises the JAX
    package's ValueError."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if avail == 0:
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for a mesh of virtual CPU shards")
        n = avail if n_devices is None else int(n_devices)
        if n > avail:
            raise ValueError(f"a mesh of {n} devices was asked for, but only "
                             f"{avail} CUDA device(s) are visible")
        devs = [torch.device("cuda", i) for i in range(n)]
    elif kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        devs = [torch.device("cpu")] * n
    else:
        raise ValueError(f"a mesh runs on cuda or cpu devices, not {kind!r}")
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    if n % chains_axis != 0:
        raise ValueError(f"{n} devices not divisible by chains_axis="
                         f"{chains_axis}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(n // chains_axis, chains_axis),
                      np.arange(n).reshape(n // chains_axis, chains_axis))


def resolve_mesh_device(mesh: DeviceMesh, device=None) -> torch.device:
    """The lead device of a fit on ``mesh``; a ``device`` argument of
    another type than the mesh's devices raises."""
    lead = mesh.lead
    if device is not None and torch.device(device).type != lead.type:
        raise ValueError(f"device={device!r} conflicts with a mesh of "
                         f"{lead.type} devices")
    return lead


def check_precision(mesh: Optional[DeviceMesh], precision: str) -> None:
    """Refuse SHMCConfig(precision='high') on a mesh whose shards run on
    more than one CUDA device: tf32x3 switches cuBLAS's process-wide TF32
    flag on around its products, so a float32 product that another
    shard's thread launches or captures meanwhile would run in TF32. A
    one-device mesh runs its one shard in the caller's thread."""
    if mesh is None or precision != "high":
        return
    leads = {str(d) for d in mesh.devices[:, 0] if d.type == "cuda"}
    if len(leads) > 1:
        raise ValueError(
            "SHMCConfig(precision='high') does not run on a mesh of more "
            "than one CUDA device (its TF32 switch is process-wide); use "
            "precision='highest' or a one-device mesh")


def _in_shard(fn, shard: Shard, n_threads: int, forked):
    # a new host thread starts from the default intra-op thread count
    # (OpenMP's is per thread): keep the caller's, or the virtual shards
    # of a CPU mesh oversubscribe the host's cores
    torch.set_num_threads(n_threads)
    dev_ctx = (torch.cuda.device(shard.device)
               if shard.device.type == "cuda" else nullcontext())
    with dev_ctx, progcache.scope(shard.tag), profiling.adopt(
            forked, shard.position):
        return fn(shard)


def run_shards(fn, shards):
    """``fn(shard)`` for every shard in host threads, one worker per
    device (with the shard's device current, its progcache scope set and
    the caller's intra-op thread count, and its spans recorded under the
    caller's open span as the shard's), the results in shard order: the
    shards of distinct devices run at once, those that share a device (a
    CPU mesh's virtual shards) one after another, as they would share its
    cores anyway. An exception in any shard propagates once every shard
    has finished."""
    if len(shards) == 1 and shards[0].tag is None:
        return [fn(shards[0])]
    n_threads = torch.get_num_threads()
    forked = profiling.fork()
    workers = len({str(sh.device) for sh in shards})
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="mesh-shard") as pool:
        futures = [pool.submit(_in_shard, fn, sh, n_threads, forked)
                   for sh in shards]
        return [f.result() for f in futures]
