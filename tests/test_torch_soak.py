"""The opt-in randomized soak of ``tests/test_soak.py`` on the port
(``VKMR_SOAK=1``): the same 40 seeded trials of chunked ingest with
mid-stream ``Root()`` calls over grouped configurations, each root held equal
three ways: the port's streaming engine on the CPU device, the JAX engine on
its ``xla`` backend with the same config, and ``oracle.merkle_root``.  Not
part of the default suite (minutes on one CPU thread).

    VKMR_SOAK=1 python -m pytest tests/test_torch_soak.py -q
"""

import os

import numpy as np
import pytest
import torch

from vk_merkle_roots_tpu.config import EngineConfig as JaxEngineConfig
from vk_merkle_roots_tpu.models.tpu import TpuSha256D
from vk_merkle_roots_tpu_torch import oracle
from vk_merkle_roots_tpu_torch.config import EngineConfig
from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D

torch.set_num_threads(1)

soak = pytest.mark.skipif(os.environ.get("VKMR_SOAK") != "1", reason="set VKMR_SOAK=1 for the long soak")


@soak
@pytest.mark.parametrize("trial", range(40))
def test_soak_randomized_engine(trial):
    rng = np.random.default_rng(40000 + trial)
    n = int(rng.integers(1, 700))
    leaves = [rng.integers(0, 256, size=int(rng.integers(1, 160)), dtype=np.uint8).tobytes() for _ in range(n)]
    if trial % 3 == 0 and n > 4:
        for i in rng.integers(0, n, size=2):
            leaves[int(i)] = rng.integers(0, 256, size=int(rng.integers(600, 3000)), dtype=np.uint8).tobytes()
    want = oracle.merkle_root(leaves).hex()
    slice_log2 = int(rng.integers(3, 9))
    batch = 1 << int(rng.integers(2, 8))  # pow-2: group-bitrev storage
    kw = dict(slice_log2=slice_log2, batch_leaves=batch)
    engines = (CudaSha256D(device="cpu", config=EngineConfig(**kw)),
               TpuSha256D(name="soak", config=JaxEngineConfig(backend="xla", **kw)))
    i = 0
    while i < n:
        step = int(rng.integers(1, 3 * batch))
        assert all(e.AddMany(leaves[i : i + step]) for e in engines)
        i += step
        if rng.random() < 0.1:
            # grow-after-root mid-stream, each engine against the oracle
            mid = oracle.merkle_root(leaves[:i]).hex()
            assert [e.Root() for e in engines] == [mid, mid], f"trial {trial} {kw} at {i} of {n}"
    assert [e.Root() for e in engines] == [want, want], f"trial {trial} {kw} n={n}"
