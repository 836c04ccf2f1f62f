"""Multi-host distribution: process bootstrap + host-aware meshes.

The reference has no multi-process backend at all (SURVEY.md section 2:
threads + mutexes only). Here ``jax.distributed`` bootstraps one process
per host; the device mesh gets an extra leading ``host`` axis that spans
processes, while ``tile``/``sample`` span the devices of one host. Film
and gradient reductions are expressed once as ``psum`` over named axes,
and XLA routes each over the links it crosses.

Usage (same code single-host and multi-host):

    from tuturenderer_tpu.parallel import distributed as dist
    dist.init_distributed()                    # no-op if single process
    mesh = dist.make_multihost_mesh()
    img = render_sharded(scene, cam, opts, mesh)
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

_initialized = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize ``jax.distributed`` across hosts.

    Arguments fall back to the standard env vars
    (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``).
    No-op when single-process or already initialized.
    """
    global _initialized
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "-1") or -1)
    try:
        if coordinator_address and num_processes > 1 and process_id >= 0:
            jax.distributed.initialize(coordinator_address, num_processes,
                                       process_id)
            _initialized = True
    except RuntimeError:
        # already initialized by the launcher
        _initialized = True


def make_multihost_mesh(sample: Optional[int] = None,
                        force_hosts: Optional[int] = None) -> Mesh:
    """("host", "tile", "sample") mesh: ``host`` spans processes,
    ``tile``/``sample`` span the devices within each host.

    Single-process fallback: host axis of size 1 over all local devices,
    so code written against this mesh runs unchanged on one host.

    ``force_hosts``: partition the local devices into this many fake host
    rows (single-process testing of the host axis — the sharding
    programs and collectives compile/run exactly as they would across
    real hosts; only the physical transport differs).
    """
    devices = jax.devices()
    n_proc = force_hosts or jax.process_count()
    per_host = len(devices) // n_proc
    if sample is None:
        sample = 1
        for cand in (4, 2):
            if per_host % cand == 0 and per_host // cand >= 1:
                sample = cand
                break
    tile = per_host // sample
    dev = np.asarray(devices).reshape(n_proc, tile, sample)
    return Mesh(dev, ("host", "tile", "sample"))


def pixel_axes(mesh: Mesh):
    """The mesh axes a flat pixel/lane array shards over (everything but
    'sample'). Returns a tuple usable inside PartitionSpec."""
    return tuple(a for a in mesh.axis_names if a != "sample")


def reduce_axes(mesh: Mesh):
    """All mesh axis names (for full psum of gradients/losses)."""
    return tuple(mesh.axis_names)
