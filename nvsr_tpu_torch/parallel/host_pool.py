"""The scene-plane pool across ranks (counterpart of
nvsr_tpu/parallel/host_pool.py).

Each scene's plane file has one owner rank, chosen by crc32 of its saved
id: only the owner reads it from disk and writes it back, and the owner
broadcasts what it read to every rank. JAX's single controller writes
each dirty scene once by construction; the port runs one process per
rank over one store directory, so without owners every rank would write
the same file, and a rank could read a scene while its owner writes it.

The device-resident pool (`nerf.train.store_planes.device_pool`) gives
each scene a home rank instead (`pool_homes`: JAX's round-robin
placement over the sorted saved ids), and the home is the owner too:
one map decides where a scene's planes live and who reads and writes
its file (planes_store.PlanesBuffer's device_pool).
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence

import torch.distributed as dist

from nvsr_tpu_torch.parallel.sharding import Mesh, broadcast_


def pool_homes(saved_ids: Sequence[str], n_ranks: int,
               extra: Sequence[str] = ()) -> dict:
    """{saved id: home rank} of the device pool: the sorted ids
    round-robin over the ranks, as JAX's Experiment places them on the
    mesh's devices in order (rank r is the mesh's r-th device). `extra`
    ids (scenes only evaluated, which JAX's placement leaves replicated)
    continue the round robin after them, sorted, so that the map names
    every scene the pool can hold."""
    ids = sorted(saved_ids)
    ids += sorted(set(extra) - set(ids))
    return {sid: i % n_ranks for i, sid in enumerate(ids)}


def scene_owner(saved_scene_id: str, n_hosts: int) -> int:
    """The owner rank of a saved scene id: crc32, not hash() (Python's
    string hash is salted per process, and ranks must agree without
    communicating); the same owner as the JAX package's."""
    return zlib.crc32(saved_scene_id.encode()) % max(n_hosts, 1)


class HostPartition:
    """One rank's view of scene ownership. process_index/process_count
    default to the process group's rank and world size (0 and 1 without
    one); pass them to lay out several ranks in one process in tests.
    owners: {saved id: rank} in crc32's place (the device pool's
    homes); it must name every id asked about."""

    def __init__(self, scenes: Sequence[str],
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 owners: Optional[dict] = None):
        live = dist.is_available() and dist.is_initialized()
        if process_count is None:
            process_count = dist.get_world_size() if live else 1
        if process_index is None:
            process_index = dist.get_rank() if live else 0
        self.process_count = process_count
        self.process_index = process_index
        self.scenes = list(scenes)
        self.owners = owners

    def owner(self, saved_scene_id: str) -> int:
        if self.owners is not None:
            return self.owners[saved_scene_id]
        return scene_owner(saved_scene_id, self.process_count)

    def owns(self, saved_scene_id: str) -> bool:
        return self.owner(saved_scene_id) == self.process_index

    @property
    def owned(self) -> list:
        return [s for s in self.scenes if self.owns(s)]

    def broadcast(self, tree, saved_scene_id: str, mesh: Optional[Mesh]):
        """The owner's tensors of `tree` (its planes and Adam moments) on
        every rank, in place: non-owners pass zeros of the same shapes
        and dtypes, and never read the scene's file. Returns `tree`; with
        one rank (or no mesh) it is returned as it is."""
        if self.process_count > 1 and mesh is not None:
            broadcast_(tree, self.owner(saved_scene_id), mesh=mesh)
        return tree

    def balance(self) -> dict:
        """Scenes per rank (a pathological corpus could skew crc32
        ownership; callers can log this)."""
        counts = {}
        for s in self.scenes:
            counts[self.owner(s)] = counts.get(self.owner(s), 0) + 1
        return counts
