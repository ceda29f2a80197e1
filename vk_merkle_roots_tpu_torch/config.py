"""Configuration of the port.

``EngineConfig`` and ``auto_host_pending_bytes`` are the port's copies of
``vk_merkle_roots_tpu/config.py`` (:15 and :114), with the same fields and
defaults, less the two that only the JAX engine reads (``backend``, the
Pallas/XLA switch, and ``stats_sample_every``, its sampled device timing:
the port's device time comes from the profiler's trace).  ``auto_slice_log2`` asks
``torch.cuda`` for free device memory.  The kernels need no
compilation-cache setting: ``_build`` keeps the built library by content
hash."""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["EngineConfig", "auto_host_pending_bytes", "auto_slice_log2"]


@dataclass
class EngineConfig:
    """Tuning knobs of the streaming engine.

    * ``slice_log2`` — leaves per slice (2^slice_log2); a slice's digest
      buffer is the reduction unit.  2^20 leaves = 32 MB of digests.
    * ``batch_leaves`` / ``batch_bytes`` — host-side flush thresholds.
    * ``host_pending_bytes`` — ceiling on payload held in the host pending
      queue plus packed-but-undispatched batches: ingest drains to the device
      until it is back under the budget before ``AddSpans`` returns, and
      fails soft (False) if the device cannot absorb the overflow.
    * ``pack_ahead`` — flush batches packed on a background thread ahead of
      device dispatch (0 packs inline on the caller's thread).
    * ``max_slices_in_flight`` — backpressure bound: past it the oldest half
      of the un-read slice roots is read back in one copy.
    * ``device_max_blocks`` — per-leaf message-block bound for device
      hashing; longer leaves hash on the host (SHA-NI or hashlib).  It also
      bounds the packed row pitch (64 KB x blocks per tile).
    * ``sharded_reduce`` — the MESH engine reduces each full slice across
      its devices (one column shard each, the roots gathered once); the
      one-device engine refuses it.
    * ``keep_digests`` — keep each slice's natural-order digests so
      ``Proof()`` works after ``Root()`` (32 B/leaf of host memory).
    * ``journal_path`` — append each completed slice's root to this JSONL
      file, which makes a stream resumable; None disables.
    * ``host_tail_leaves`` — ragged tails at or below this leaf count reduce
      on the host (one readback and the native reduce) instead of the
      device's binary decomposition; 0 forces the device path.
    """

    slice_log2: int = 20
    batch_leaves: int = 1 << 16
    batch_bytes: int = 64 << 20
    host_pending_bytes: int = 256 << 20
    pack_ahead: int = 2
    max_slices_in_flight: int = 8
    device_max_blocks: int = 2048
    sharded_reduce: bool = False
    keep_digests: bool = False
    journal_path: str | None = None
    host_tail_leaves: int = 8192


def auto_slice_log2(device, max_fraction: float = 0.125, default: int = 20, cap: int = 26) -> int:
    """The largest power-of-two leaf count whose 32 B/leaf slice buffer
    stays under ``max_fraction`` of the device's free memory (counterpart of
    ``vk_merkle_roots_tpu/config.py:98``); ``default`` off CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return default
    free, _total = torch.cuda.mem_get_info(device)
    k = max((int(free * max_fraction) // 32).bit_length() - 1, 10)
    return min(k, cap)


def auto_host_pending_bytes(max_fraction: float = 0.25, default: int = 256 << 20, cap: int = 1 << 30) -> int:
    """The host staging budget from available memory: ``max_fraction`` of
    ``MemAvailable`` in ``/proc/meminfo``, clamped to [64 MB, cap]; the
    declared default off Linux."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    kb = int(line.split()[1])
                    budget = int(kb * 1024 * max_fraction)
                    return max(64 << 20, min(budget, cap))
    except OSError:
        pass
    return default
