"""Multi-device streaming engine: ``CudaSha256D`` with its work spread over
several devices.  Port of ``vk_merkle_roots_tpu/models/mesh.py``.

The slice buffer lives on the first device of the list, the primary.  The
engine fans out at two points, each with a round-robin counter:

* each packed **batch** hashes (K1/K4) on the next device in turn, into a
  fresh ``(8, n)`` tensor there, and is copied into the primary's slice
  buffer (an ``index_copy_`` for a partial flush into a grouped slice); the
  single-device engine's in-place hash+append would pin both to one card;
* each full **slice** is copied to the next device in turn and reduced
  there (grouped or natural, as on one device), its root left there until
  it is read back.

With ``sharded_reduce`` a full slice instead splits into equal column
shards over the power-of-two prefix of the devices, each reduced on its
device, and the shard roots meet in one gather (:mod:`..parallel.mesh`); a
group-bitrev slice is put in natural order first.

Every device runs the kernels or raises: a CUDA device is never replaced by
the CPU.  The list may name a device more than once (a one-card machine
runs a mesh of two that way).  The ``map_device`` and ``reduce_device``
stage times are CUDA events on the primary's stream: they cover the
primary's own work and its waits on the other cards, not the other cards'
kernels.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig
from ..ops.leaf_hash import leaf_hashes
from ..ops.tree_reduce import group_bitrev_to_natural
from ..parallel.mesh import make_mesh, make_sharded_reduce_fn, shard_digests
from ..utils.bitmath import largest_pow2_le
from .cuda import CudaSha256D


class MeshCudaSha256D(CudaSha256D):
    """Streaming SHA-256d Merkle-root engine over a list of torch devices
    (default: every CUDA card)."""

    _SHARDED_REDUCE = True

    def __init__(self, devices=None, name: str | None = None, config: EngineConfig | None = None) -> None:
        self._devices = list(make_mesh(devices).devices)
        primary = self._devices[0]
        if name is None:
            kind = torch.cuda.get_device_name(primary) if primary.type == "cuda" else "TORCH"
            name = f"{kind} x{len(self._devices)}"
        self._mesh = self._sharded_fn = None
        super().__init__(device=primary, name=name, config=config)

    def _append(self, packed, group_flush: bool) -> None:
        dev = self._devices[self._batch_rr % len(self._devices)]
        self._batch_rr += 1
        self._place(leaf_hashes(packed, dev).to(self.device), group_flush)

    def _sharded_reduce(self):
        """The cached sharded slice reducer over the power-of-two prefix of
        the devices."""
        if self._sharded_fn is None:
            ndev = largest_pow2_le(len(self._devices))
            self._mesh = make_mesh(self._devices, n_devices=ndev)
            self._sharded_fn = make_sharded_reduce_fn(self._mesh, self.config.slice_log2)
        return self._mesh, self._sharded_fn

    def _reduce_slice_root(self, buf: torch.Tensor) -> torch.Tensor:
        if self.config.sharded_reduce:
            if self._slice_grouped:
                buf = group_bitrev_to_natural(buf, self.config.slice_log2, self._group_log2)
            mesh, fn = self._sharded_reduce()
            return fn(shard_digests(mesh, buf))
        dev = self._devices[self._slice_rr % len(self._devices)]
        self._slice_rr += 1
        return super()._reduce_slice_root(buf.to(dev))

    def Reset(self) -> bool:
        self._batch_rr = 0
        self._slice_rr = 0
        return super().Reset()

    def Stats(self) -> dict:
        stats = super().Stats()
        stats["devices"] = len(self._devices)
        return stats
