"""The scene-plane pool across ranks (counterpart of
nvsr_tpu/parallel/host_pool.py).

Each scene's plane file has one owner rank, chosen by crc32 of its saved
id: only the owner reads it from disk and writes it back, and the owner
broadcasts what it read to every rank. JAX's single controller writes
each dirty scene once by construction; the port runs one process per
rank over one store directory, so without owners every rank would write
the same file, and a rank could read a scene while its owner writes it.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence

import torch.distributed as dist

from nvsr_tpu_torch.parallel.sharding import Mesh, broadcast_


def scene_owner(saved_scene_id: str, n_hosts: int) -> int:
    """The owner rank of a saved scene id: crc32, not hash() (Python's
    string hash is salted per process, and ranks must agree without
    communicating); the same owner as the JAX package's."""
    return zlib.crc32(saved_scene_id.encode()) % max(n_hosts, 1)


class HostPartition:
    """One rank's view of scene ownership. process_index/process_count
    default to the process group's rank and world size (0 and 1 without
    one); pass them to lay out several ranks in one process in tests."""

    def __init__(self, scenes: Sequence[str],
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        live = dist.is_available() and dist.is_initialized()
        if process_count is None:
            process_count = dist.get_world_size() if live else 1
        if process_index is None:
            process_index = dist.get_rank() if live else 0
        self.process_count = process_count
        self.process_index = process_index
        self.scenes = list(scenes)

    def owner(self, saved_scene_id: str) -> int:
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
