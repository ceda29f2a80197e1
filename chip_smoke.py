#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each fatal on failure:

1. environment: Python, torch, CUDA, nvcc, and the card's name and power limit;
2. build: every kernel of ``vk_merkle_roots_tpu_torch/csrc`` at first use;
3. each kernel on the card against its plain PyTorch version on CPU copies
   (byte-exact) and against hashlib; then, at the main path's shapes, timed
   beside the plain version on the same card tensors and held byte-exact
   against it there too: K1 and K4 on a whole flush of each engine stream,
   bucket by bucket and in one launch, in turns, K4 also on one 64-block
   leaf alone (its chain floor); K3 on a full slice's 16 natural-order group
   roots, on 1024 bit-reversed digests and on the 12345-digest ragged tail
   that stream 1 leaves, block by block and in one launch, in turns, and the
   ragged tail's whole device part (one K3 launch) with its host enqueue; a
   full grouped slice's reduction must run no gather; K3 once on each of
   eight shapes (1 to 1024 bit-reversed digests, 16 natural-order group
   roots, the ragged tail);
4. the streaming engine ``CudaSha256D`` at the JAX engine's default size
   (2^20-leaf slices, 2^16-leaf batches) on ``rndm 1712489279 (2^21+12345)
   127`` and on a stream with 1-8 KB leaves mixed in; each root must equal
   the native host root, every kernel must have launched, K1 and K4 at most
   once a packed flush, K3 once a full slice and once for a ragged tail on
   the card, and no plain path may have run;
5. the CLI, ``python -m vk_merkle_roots_tpu_torch.cli``, on the canonical
   ``rndm 1712489279 1024 127`` stream (root 050194bb...) and on
   ``rndm 1712489279 (2^22+3) 127`` with the default auto slice;
6. the roofline and the batch API: the integer-issue probes K5 and K6
   against their plain versions (1 tile on CPU copies, 256 tiles on the
   card, byte-exact) and timed; the SASS counts of every kernel, K5's pass
   loop holding at least 512 integer instructions; the perf model's JSON
   (``tools/perf_model.py``), whose run is the probes' main path;
   ``merkle_root_device`` on ``rndm 1712489279 2^20 127``, the fused step
   and ``entry()`` on 2^14 64-byte leaves, each equal to the native host
   root; and a process with ``VKMR_KERNEL_DEBUG=1``, which builds the
   library with the debug hook and whose K1 launch must print its tags;
7. the journal, resume and proofs, at 2^20-leaf slices and 2^16-leaf
   batches: the CLI with ``--journal --proof`` on the first 2^21+5000 leaves
   of ``rndm 1712489279 (2^22+3) 127`` (two journal rows, two sidecars),
   resumed on the whole stream without ``--slice-log2`` (the journal's
   height adopted, the host root, a proof of a journaled leaf checked by
   ``vk_merkle_roots_tpu_torch/tools/verify.py``), refused on a stream with one
   byte changed in the prefix; then ``CudaSha256D`` with ``keep_digests``
   and a journal on the phase-4 streams, beside the same runs without them,
   proofs of a leaf in every slice verified; every kernel launched and no
   plain path ran;
8. multi-device and multi-process: the card count, and a device list of
   every card (or ``cuda:0`` twice on a one-card machine); ``MeshCudaSha256D``
   round robin and with ``sharded_reduce`` on phase 4's short-leaf stream,
   in turns with the one-device engine, each root the native host root, K1,
   K2 and K3 launched on every listed card and no plain path run; a full
   slice's reduction sharded against one device's, timed; the sharded root
   and the sharded reduce of ``parallel/mesh.py`` on 2^20 leaves of 24 B,
   each the oracle's root with one ``ndev x 32 B`` gather; two ranks of
   ``python -m vk_merkle_roots_tpu_torch.parallel.distributed`` as
   subprocesses, both printing the oracle root twice; ``dryrun_multichip``
   on the device list;
9. randomized differential: 48 seeded trials of ``tools/fuzz.py`` on the
   card, each drawing its config (slice 2^3-2^16, grouped or natural batches,
   host or device tails, pack-ahead 0-3, 1-8 KB leaves, host-routed leaves,
   ``keep_digests``), its leaves and its calls (``AddMany`` chunks,
   mid-stream ``Root()``, ``Drain()``, ``Reset()``) from its seed, trials 2
   and 3 of every 16 on ``MeshCudaSha256D`` over phase 8's device list; every
   root must equal the native host root and every proof verify, K1-K4 must
   have launched and no plain path run; each failing check prints its
   trial's seed and config, and the phase fails after the last trial.

The line before the last is one JSON object with each kernel's launches on
the main path, its largest difference from the plain version, both times,
its bound (ALU-pipe issue from its SASS, or bytes; for K3 also the chain of
its levels and for K4 the chain of its longest leaf's compressions, each
counted as the rounds of K3's round warp, ``chain_bound_ms``) and no library time (no PyTorch op computes
SHA-256); the last line is ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without a CUDA device or outside the
repository.
The port imports neither JAX nor the JAX package, and neither does this
script.
"""

from __future__ import annotations

import ctypes
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1712489279
RAGGED = 12345  # the ragged tail of smoke stream 1, (2^21 + 12345) leaves in 2^20-leaf slices
SPINS = (5_000_000, 20_000_000, 80_000_000, 320_000_000)  # clocks of a timing window's spin: ~2.5 to ~160 ms

# Run with VKMR_KERNEL_DEBUG=1: builds the debug library, launches K1 once
# on 8 CTAs of 128 leaves and prints digest word 0 of leaf 0.
KDEBUG_CHILD = """
import numpy as np, torch
from vk_merkle_roots_tpu_torch import _build
from vk_merkle_roots_tpu_torch.ops import leaf_hash as lh
dev = torch.device("cuda", 0)
words = np.random.default_rng(3).integers(0, 2**32, (1, 16, 8, 128), np.uint32)
out = torch.empty((8, 1024), dtype=torch.int32, device=dev)
lh.exact_hash_into(lh.to_device_words(words, dev), 1, 1024, out, 0)
torch.cuda.synchronize()
print("library", _build.library_path().name, "d0", int(out[0, 0]) & 0xFFFFFFFF, flush=True)
"""


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def run_text(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def host_root(stream: bytes) -> str:
    from vk_merkle_roots_tpu_torch.models.cpu import CpuSha256D
    from vk_merkle_roots_tpu_torch.packing import split_lines

    ref = CpuSha256D()
    ref.AddSpans(*split_lines(stream))
    return ref.Root()


def journal_phase(dev, smi: str, engine_streams) -> None:
    """Phase 7: the journal, resume and proofs on the card, through the CLI
    and through ``CudaSha256D``; see the module docstring."""
    import torch

    from vk_merkle_roots_tpu_torch import _build, oracle
    from vk_merkle_roots_tpu_torch.config import EngineConfig
    from vk_merkle_roots_tpu_torch.ingest import iter_line_spans
    from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D, load_digest_sidecars
    from vk_merkle_roots_tpu_torch.native.lib import native_rndm_stream
    from vk_merkle_roots_tpu_torch.packing import split_lines

    slice_log2, batch = 20, 1 << 16
    cap = 1 << slice_log2
    cli = [sys.executable, "-m", "vk_merkle_roots_tpu_torch.cli", "--batch-leaves", str(batch)]

    def run_cli(args, stream: bytes):
        t0 = time.perf_counter()
        proc = subprocess.run(cli + args, input=stream, capture_output=True, cwd=REPO, timeout=600)
        return proc, proc.stdout.decode(), proc.stderr.decode(), time.perf_counter() - t0

    def root_of(out: str) -> str:
        return out.split("=> ")[1].split(" ")[0]

    def verify_with_tool(out: str, leaf: bytes, where: str) -> None:
        path = os.path.join(tmp, "proof.json")
        with open(path, "w") as fh:
            fh.write(out.strip().splitlines()[-1])
        proc = subprocess.run([sys.executable, "-m", "vk_merkle_roots_tpu_torch.tools.verify", path, "--leaf-hex", leaf.hex()],
                              capture_output=True, text=True, cwd=REPO, timeout=120)
        check(proc.returncode == 0 and proc.stdout.startswith("OK "), f"{where}: verify.py refused: {proc.stderr}")

    def leaf_of(stream_offs, stream_lens, stream: bytes, i: int) -> bytes:
        return stream[int(stream_offs[i]) : int(stream_offs[i] + stream_lens[i])]

    n_full = (1 << 22) + 3
    full = native_rndm_stream(SEED, n_full, 127)
    _, offs, lens = split_lines(full)  # rndm leaves are 1-126 bytes: no empty lines
    n_a = (1 << 21) + 5000
    prefix = full[: int(offs[n_a])]
    want_full, want_prefix = host_root(full), host_root(prefix)
    with tempfile.TemporaryDirectory(prefix="vkmr-smoke-journal-") as tmp:
        journal = os.path.join(tmp, "j.jsonl")

        # (a) The first CLI run journals two full slices with their sidecars.
        proc, out, err, wall = run_cli(["--slice-log2", str(slice_log2), "--journal", journal, "--proof", "10"], prefix)
        check(proc.returncode == 0, f"journaling CLI exited {proc.returncode}: {err[-3000:]}")
        check(root_of(out) == want_prefix, f"journaling CLI root {root_of(out)} != host root {want_prefix}")
        with open(journal) as fh:
            rows = [json.loads(line) for line in fh]
        check(len(rows) == 2 and all({"bytes", "sha256"} <= set(r) for r in rows),
              f"journal rows after 2^21+5000 leaves: {rows}")
        check(rows[1]["bytes"] == int(lens[: 2 * cap].sum()), f"journal bytes {rows[1]['bytes']}")
        roots = [bytes.fromhex(r["root"]) for r in rows]
        sides = load_digest_sidecars(journal, roots, cap)
        check(sides is not None and all(s.shape == (cap, 8) for s in sides), "sidecars missing or misshapen")
        verify_with_tool(out, leaf_of(offs, lens, full, 10), "first run, leaf 10")
        print(f"(a) CLI --slice-log2 20 --journal --proof 10, {n_a} leaves: root {root_of(out)[:16]}... == host"
              f" root; 2 journal rows, 2 sidecars of {sides[0].shape}; {wall:.2f} s wall")

        # (b) Resume on the whole stream at the CLI's default (auto) slice.
        leaf = 777  # in journaled slice 0
        proc, out, err, wall = run_cli(["--journal", journal, "--proof", str(leaf)], full)
        check(proc.returncode == 0, f"resuming CLI exited {proc.returncode}: {err[-3000:]}")
        check("journal was written with slice_log2=20; resuming with that" in err, f"height not adopted: {err[-2000:]}")
        check(f"Resuming from journal: 2 slice(s), skipping {2 * cap} leaf/leaves" in err, f"no resume: {err[-2000:]}")
        check(root_of(out) == want_full, f"resumed root {root_of(out)} != host root {want_full}")
        verify_with_tool(out, leaf_of(offs, lens, full, leaf), f"resume, leaf {leaf}")
        with open(journal) as fh:
            n_rows = len(fh.readlines())
        check(n_rows == 4, f"the resumed run left {n_rows} journal rows, want 4")
        print(f"(b) resume on {n_full} leaves, no --slice-log2: slice_log2=20 adopted, 2 slices skipped, root"
              f" {root_of(out)[:16]}... == host root, --proof {leaf} verified by verify.py; resume wall {wall:.2f} s")

        # (c) One byte changed inside the journaled prefix: refused, no root.
        bad = bytearray(full)
        pos = int(offs[12345])
        bad[pos] = ord("A") if bad[pos] != ord("A") else ord("B")
        proc, out, err, wall = run_cli(["--journal", journal], bytes(bad))
        del bad
        check(proc.returncode == 1 and "journal/stream mismatch" in err and "=>" not in out,
              f"perturbed stream: exit {proc.returncode}, stdout {out[-500:]!r}, stderr {err[-1000:]!r}")
        print(f"(c) one byte changed in the prefix: exit 1, 'journal/stream mismatch', no root; {wall:.2f} s wall")

        # (d) The engine API, with and without keep_digests and the journal.
        def timed(fn, sink):
            def run(*args):
                torch.cuda.synchronize(dev)  # the readback would wait for the hashing anyway
                t = time.perf_counter()
                result = fn(*args)
                sink.append((time.perf_counter() - t) * 1e3)
                return result
            return run

        _build.reset_counts()
        for k, (title, stream, count) in enumerate(engine_streams):
            want = host_root(stream)
            jpath = os.path.join(tmp, f"engine{k}.jsonl")
            for mode, extra in (("plain", {}), ("journal+keep_digests", dict(keep_digests=True, journal_path=jpath))):
                engine = CudaSha256D(device=dev, config=EngineConfig(slice_log2=slice_log2, batch_leaves=batch, **extra))
                snap_ms, side_ms = [], []
                engine._read_digests = timed(engine._read_digests, snap_ms)
                engine._save_digest_sidecar = timed(engine._save_digest_sidecar, side_ms)
                nbytes = 0
                t0 = time.perf_counter()
                for d, o, ln in iter_line_spans(io.BytesIO(stream)):
                    check(engine.AddSpans(d, o, ln), f"{title} ({mode}): AddSpans refused")
                    nbytes += int(ln.sum())
                root = engine.Root()
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
                check(root == want, f"{title} ({mode}): root {root} != host root {want}")
                print(f"{title} ({mode}): {nbytes / wall / 1e9:.3f} GB/s payload, {wall:.3f} s wall")
            full_slices = count // cap
            with open(jpath) as fh:
                jrows = [json.loads(line) for line in fh]
            check(len(jrows) == full_slices, f"{title}: {len(jrows)} journal rows, want {full_slices}")
            print(f"  snapshot (device un-permute + one 32 MB D2H) ms per full slice:"
                  f" {', '.join(f'{t:.2f}' for t in snap_ms[:full_slices])}; tail snapshot"
                  f" {', '.join(f'{t:.2f}' for t in snap_ms[full_slices:]) or 'none'};"
                  f" sidecar write ms {', '.join(f'{t:.2f}' for t in side_ms)}")
            _, s_offs, s_lens = split_lines(stream)
            picks = [s * cap + 777 for s in range(full_slices)] + ([count - 1] if count % cap else [])
            proof_ms = []
            for i in picks:
                t = time.perf_counter()
                path = engine.Proof(i)
                proof_ms.append((time.perf_counter() - t) * 1e3)
                got = oracle.verify_proof(oracle.leaf_hash(leaf_of(s_offs, s_lens, stream, i)), path).hex()
                check(got == want, f"{title}: the proof of leaf {i} folds to {got}, not the root {want}")
            print(f"  Proof() ms (leaf: ms), every path verified: {', '.join(f'{i}: {t:.1f}' for i, t in zip(picks, proof_ms))}")
    launches, plain_calls = dict(_build.launches), dict(_build.plain_calls)
    print(f"launches in the engine runs of the phase: {launches}; plain calls: {plain_calls}")
    for name in ("leaf_hash_exact", "leaf_hash_stream", "fold_level", "tail_reduce"):
        check(launches.get(name, 0) > 0, f"kernel {name} never launched in the journal phase")
    check(not plain_calls, f"plain PyTorch paths ran in the journal phase: {plain_calls}")
    print(smi)


def multi_device_phase(smi: str, stream: bytes, cuda_ms) -> None:
    """Phase 8: the MESH engine, the sharded root and reduce, two ranks and
    ``dryrun_multichip``; see the module docstring."""
    import socket

    import numpy as np
    import torch

    from vk_merkle_roots_tpu_torch import _build, oracle
    from vk_merkle_roots_tpu_torch.config import EngineConfig
    from vk_merkle_roots_tpu_torch.entry import dryrun_multichip
    from vk_merkle_roots_tpu_torch.ingest import iter_line_spans
    from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D
    from vk_merkle_roots_tpu_torch.models.mesh import MeshCudaSha256D
    from vk_merkle_roots_tpu_torch.ops import tree_reduce as tr
    from vk_merkle_roots_tpu_torch.ops.leaf_hash import host_leaf_digest_cols, to_device_words
    from vk_merkle_roots_tpu_torch.packing import pack_leaves
    from vk_merkle_roots_tpu_torch.parallel import mesh as pm
    from vk_merkle_roots_tpu_torch.parallel.distributed import demo_leaves
    from vk_merkle_roots_tpu_torch.utils.hexutil import words_to_digest

    cards = torch.cuda.device_count()
    print(f"CUDA cards visible: {cards}")
    devices = [torch.device("cuda", i) for i in range(cards)] if cards >= 2 else [torch.device("cuda", 0)] * 2
    prefix = devices[: 1 << (len(devices).bit_length() - 1)]  # the sharded reduce's devices
    print(f"device list: {', '.join(map(str, devices))} ({'every card' if cards >= 2 else 'the one card named twice'});"
          f" sharded over the first {len(prefix)}")
    indices = sorted({d.index for d in devices})

    def sync_all() -> None:
        for i in indices:
            torch.cuda.synchronize(i)

    def root_hex(t: torch.Tensor) -> str:
        return words_to_digest(t.cpu().numpy().view(np.uint32)).hex()

    ranks = []
    try:
        # (a) The engines on the phase-4 short-leaf stream, in turns.
        want = host_root(stream)
        cfg = dict(slice_log2=20, batch_leaves=1 << 16)
        runs = [("one device", None), ("MESH round robin", False), ("MESH sharded_reduce", True), ("one device", None)]
        k1_cards, k23_cards, gbps = set(), set(), {}
        for title, sharded in runs:
            if sharded is None:
                engine = CudaSha256D(device=devices[0], config=EngineConfig(**cfg))
            else:
                engine = MeshCudaSha256D(devices, config=EngineConfig(sharded_reduce=sharded, **cfg))
            _build.reset_counts()
            nbytes, t0 = 0, time.perf_counter()
            for d, o, ln in iter_line_spans(io.BytesIO(stream)):
                check(engine.AddSpans(d, o, ln), f"{title}: AddSpans refused")
                nbytes += int(ln.sum())
            root = engine.Root()
            sync_all()
            wall = time.perf_counter() - t0
            by_card, plain = dict(_build.device_launches), dict(_build.plain_calls)
            check(root == want, f"{title}: root {root} != native host root {want}")
            check(not plain, f"{title}: plain PyTorch paths ran: {plain}")
            gbps.setdefault(title, []).append(nbytes / wall / 1e9)
            slices = engine.Stats()["slices_completed"]
            print(f"{title}: root {root[:16]}... == host root; {nbytes / wall / 1e9:.3f} GB/s payload, {wall:.3f} s"
                  f" wall; {slices} full slices; launches by (kernel, card): {dict(sorted(by_card.items()))}")
            if sharded is None:
                continue
            for i in indices:
                check(by_card.get(("leaf_hash_exact", i), 0) > 0, f"{title}: K1 never launched on cuda:{i}")
            k1_cards |= {i for (name, i) in by_card if name == "leaf_hash_exact"}
            k23_cards |= ({i for (name, i) in by_card if name == "fold_level"}
                          & {i for (name, i) in by_card if name == "tail_reduce"})
            if sharded:
                check(engine._mesh.gathers == [(len(prefix), 8)] * slices,
                      f"{title}: gathers {engine._mesh.gathers}, want one ({len(prefix)}, 8) a full slice")
            else:
                check(engine._slice_rr == slices, f"{title}: {engine._slice_rr} slices round-robined, want {slices}")
        check(k1_cards >= set(indices) and k23_cards >= {d.index for d in prefix},
              f"K1 ran on cards {sorted(k1_cards)}, K2 and K3 on {sorted(k23_cards)}; listed {indices}")
        print("GB/s payload in turns: " + "; ".join(f"{t} {', '.join(f'{g:.3f}' for g in v)}" for t, v in gbps.items())
              + f"; K1 on cards {sorted(k1_cards)}, K2 and K3 on cards {sorted(k23_cards)}")

        # (b) One full grouped slice (2^20 digests in 16 groups), reduced as the
        # one-device engine does and as the sharded engine does, in turns.
        rng = np.random.default_rng(SEED + 8)
        slice_dev = torch.from_numpy(rng.integers(0, 2**32, size=(8, 1 << 20), dtype=np.uint32).view(np.int32)).to(devices[0])
        mesh = pm.make_mesh(prefix)
        sharded_fn = pm.make_sharded_reduce_fn(mesh, 20)
        forms = {"one device": lambda: tr.reduce_grouped_body(slice_dev, 20, 16),
                 "sharded": lambda: sharded_fn(pm.shard_digests(mesh, tr.group_bitrev_to_natural(slice_dev, 20, 16)))}
        turns = []
        for kind in ("one device", "sharded", "sharded", "one device"):
            t, got = cuda_ms(forms[kind], 10)
            turns.append((kind, t))
            check(root_hex(got) == root_hex(forms["one device"]()), f"slice reduce ({kind}) root differs")
        print(f"full grouped 2^20-digest slice reduced, ms a slice in turns (CUDA events on cuda:{devices[0].index}):"
              + ", ".join(f" {k} {t:.4f}" for k, t in turns) + f"; sharded over {len(prefix)} devices")

        # Two ranks of the demo start now, after the timed runs, and run beside
        # (c) and (d), each on cuda:<rank % cards>; (e) reads their output.
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        n_demo = 1 << 20
        ranks = [subprocess.Popen([sys.executable, "-m", "vk_merkle_roots_tpu_torch.parallel.distributed", "--coordinator",
                                   f"localhost:{port}", "--num-processes", "2", "--process-id", str(r), "--leaves",
                                   str(n_demo)], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in (0, 1)]

        # (c) The sharded root and the sharded reduce on 2^20 leaves of 24 B.
        leaves = demo_leaves(7, n_demo, 24)
        want_demo = oracle.merkle_root(leaves).hex()
        bucket = pack_leaves(leaves).buckets[0]
        mesh = pm.make_mesh(prefix)
        _build.reset_counts()
        root_fn = pm.make_sharded_root_fn(mesh, n_demo, bucket.nblocks)
        got = root_hex(root_fn(pm.shard_words(mesh, bucket.words)))
        by_card, plain = dict(_build.device_launches), dict(_build.plain_calls)
        check(got == want_demo, f"sharded root {got} != oracle root {want_demo}")
        check(not plain, f"plain PyTorch paths ran in the sharded root: {plain}")
        for name in ("leaf_hash_exact", "fold_level", "tail_reduce"):
            for i in {d.index for d in prefix}:
                check(by_card.get((name, i), 0) > 0, f"sharded root: {name} never launched on cuda:{i}")
        data = np.frombuffer(b"".join(leaves), np.uint8)
        cols = to_device_words(host_leaf_digest_cols(data, np.arange(n_demo, dtype=np.int64) * 24,
                                                     np.full(n_demo, 24, np.int64)), "cpu")
        got2 = root_hex(pm.make_sharded_reduce_fn(mesh, 20)(pm.shard_digests(mesh, cols)))
        check(got2 == want_demo, f"sharded reduce root {got2} != oracle root {want_demo}")
        check(mesh.gathers == [(len(prefix), 8)] * 2, f"gathers {mesh.gathers}, want one ({len(prefix)}, 8) a root")
        print(f"parallel/mesh.py, 2^20 leaves of 24 B over {len(prefix)} devices: sharded root and sharded reduce"
              f" {want_demo[:16]}... == oracle; gathers {mesh.gathers} (one of {len(prefix)} x 32 B a root);"
              f" launches by (kernel, card): {dict(sorted(by_card.items()))}")

        # (d) dryrun_multichip on the device list (its power-of-two prefix).
        t0 = time.perf_counter()
        dryrun_multichip(len(prefix), devices)
        print(f"dryrun_multichip: {time.perf_counter() - t0:.2f} s")

        # (e) The two ranks.
        for r, proc in enumerate(ranks):
            out, err = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"rank {r} exited {proc.returncode}: {err[-3000:]}")
            lines = dict(line.split(maxsplit=1) for line in out.strip().splitlines())
            check(lines.get("sharded_root") == lines.get("sharded_reduce_root") == want_demo,
                  f"rank {r} printed {out!r}, want the oracle root {want_demo} twice")
            check("gathers [(2, 8), (2, 8)]" in lines.get("backend", ""), f"rank {r}: {out!r}")
            print(f"rank {r}: sharded_root and sharded_reduce_root == oracle; backend {lines['backend']}")
        if cards < 2:
            print("one card: both ranks ran on cuda:0 over gloo; the NCCL path (a card a rank) was not run")
    finally:
        for proc in ranks:
            proc.kill()
            proc.wait()
    print(smi)


def randomized_phase(smi: str) -> None:
    """Phase 9: the seeded randomized differential of ``tools/fuzz.py`` on
    the card; see the module docstring.  ``fuzz.run`` prints each failing
    check with its trial's seed and config and resets the kernel counts
    before the first trial."""
    import torch

    from vk_merkle_roots_tpu_torch import _build
    from vk_merkle_roots_tpu_torch.tools import fuzz

    cards = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(cards)] if cards >= 2 else [torch.device("cuda", 0)] * 2
    trials = [fuzz.draw_trial(i) for i in range(48)]
    summary = fuzz.run(trials, devices)
    torch.cuda.synchronize()
    launches, plain = dict(_build.launches), dict(_build.plain_calls)
    print(f"launches in the randomized trials: {launches}; plain calls: {plain}")
    for name in ("leaf_hash_exact", "leaf_hash_stream", "fold_level", "tail_reduce"):
        check(launches.get(name, 0) > 0, f"kernel {name} never launched in the randomized trials")
    check(not plain, f"plain PyTorch paths ran in the randomized trials: {plain}")
    check(summary["trials"] == len(trials), f"randomized trials: {summary}")
    check(summary["mismatches"] == 0, f"{summary['mismatches']} mismatches in the randomized trials, each printed"
          f" above with its trial's seed and config")
    print(f"randomized differential: {summary['trials']} trials ({', '.join(f'{n} {k}' for k, n in summary['kinds'].items())}),"
          f" {summary['leaves']} leaves, {summary['roots']} roots and {summary['proofs']} proofs checked,"
          f" {summary['mismatches']} mismatches; largest K1 table {summary['leaf_table_max']} buckets, K4 table"
          f" {summary['stream_table_max']} rungs, K3 table {summary['tail_table_max']} blocks; K3 cluster launches"
          f" {summary['tail_cluster_launches']} of {summary['tail_launches']}; {summary['wall_s']:.1f} s of trials"
          f" on {', '.join(map(str, devices))}")
    print(smi)


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run", file=sys.stderr)
        return 1
    import numpy as np

    from vk_merkle_roots_tpu_torch import _build, oracle
    from vk_merkle_roots_tpu_torch.config import EngineConfig
    from vk_merkle_roots_tpu_torch.entry import entry
    from vk_merkle_roots_tpu_torch.ingest import iter_line_spans
    from vk_merkle_roots_tpu_torch.models.cpu import CpuSha256D
    from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D
    from vk_merkle_roots_tpu_torch.native.lib import native_available, native_rndm_stream, native_shani_active
    from vk_merkle_roots_tpu_torch.ops import leaf_hash as lh
    from vk_merkle_roots_tpu_torch.ops import merkle
    from vk_merkle_roots_tpu_torch.ops import perf_probe as pp
    from vk_merkle_roots_tpu_torch.ops import tree_reduce as tr
    from vk_merkle_roots_tpu_torch.packing import FlushColumns, pack_flush, pack_spans, split_lines
    from vk_merkle_roots_tpu_torch.tools import perf_model
    from vk_merkle_roots_tpu_torch.utils.bitmath import bit_reverse_indices
    from vk_merkle_roots_tpu_torch.utils.hexutil import words_to_digest

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # -- 1. environment ------------------------------------------------------
    phase("environment")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("nvcc:", run_text([_build.cuda_tool("nvcc"), "--version"]).splitlines()[-1])
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(smi)
    print(f"devices: {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")

    # -- 2. build ------------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    check(native_available(), "the native host library (packer, rndm) did not build")
    print(f"native host library ready in {time.perf_counter() - t0:.2f} s"
          f" (g++: {'%.2f s' % _build.host_build_seconds if _build.host_build_seconds else 'already built'});"
          f" SHA-NI: {native_shani_active()}")
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel library {_build.library_path().name} ready in {time.perf_counter() - t0:.2f} s"
          f" (nvcc: {'%.2f s' % _build.build_seconds if _build.build_seconds else 'already built'})")
    for line in _build.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # -- 3. kernels against their plain versions ------------------------------
    phase("kernels against their plain PyTorch versions")

    def u32(t: torch.Tensor) -> np.ndarray:
        return t.cpu().contiguous().numpy().view(np.uint32)

    def abs_err(a: np.ndarray, b: np.ndarray) -> int:
        check(a.shape == b.shape, f"shape {a.shape} != {b.shape}")
        return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) if a.size else 0

    def cuda_ms(fn, reps: int, warm: bool = True, plain: bool = False):
        """Mean ms per call over ``reps`` calls, and the last call's result.
        Unless ``warm`` is False, calls run back to back for 50 ms first.  A
        plain version's host enqueues its thousands of small launches slower
        than the card runs them (``plain``): its window holds the host's time
        too, and is taken once."""
        t_warm = time.perf_counter()
        while warm and time.perf_counter() - t_warm < 0.05:
            fn()
            torch.cuda.synchronize()
        torch.cuda.synchronize()
        return spun_window(fn, reps, (5_000_000,) if plain else SPINS, plain)

    def spun_window(fn, reps: int, spins=SPINS, plain: bool = False):
        """(ms per call, last result) of ``reps`` calls in one CUDA-event
        window that opens after a spin on the card.  The window counts only
        if every launch was queued while the card still spun (the start
        event not yet reached), so a pause of the host cannot leave gaps in
        it; else it runs again after a spin four times as long."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for spin in spins:
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(reps):
                result = fn()
            end.record()
            queued_in_time = not start.query()
            end.synchronize()
            if queued_in_time or plain:
                return start.elapsed_time(end) / reps, result
        raise SmokeFailure("the host could not queue a timing window's launches within a ~160 ms spin")

    def timed_with_host(fn, reps: int):
        """(ms per call on the card, ms per call of host enqueue) over
        ``reps`` calls after a warm-up call, the card's time from
        :func:`spun_window`."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return spun_window(fn, reps)[0], host

    def spans_of(leaves):
        lengths = np.array([len(x) for x in leaves], np.int64)
        offsets = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
        return np.frombuffer(b"".join(leaves), np.uint8), offsets, lengths

    def rand_leaves(lengths):
        return [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lengths]

    def check_digests(cols: np.ndarray, leaves, what: str) -> None:
        got = [words_to_digest(cols[:, i]) for i in range(len(leaves))]
        check(got == [oracle.leaf_hash(x) for x in leaves], f"{what}: digests differ from hashlib")

    err = {"leaf_hash_exact": 0, "leaf_hash_stream": 0, "fold_level": 0, "tail_reduce": 0}

    # K1: exact buckets of 1..8 blocks, 3000 leaves each (not a multiple of 1024).
    for nb in range(1, 9):
        lo, hi = max(1, (nb - 1) * 64 - 8), nb * 64 - 9
        leaves = rand_leaves(rng.integers(lo, hi + 1, size=3000))
        (b,) = pack_spans(*spans_of(leaves)).buckets
        check(b.counts is None and b.nblocks == nb, f"expected one exact bucket of {nb} blocks")
        out = torch.empty((8, b.count), dtype=torch.int32, device=dev)
        lh.exact_hash_into(lh.to_device_words(b.words, dev), nb, b.count, out, 0)
        torch.cuda.synchronize()
        plain = lh.exact_hash_plain(lh.to_device_words(b.words, "cpu"), nb, b.count)
        err["leaf_hash_exact"] = max(err["leaf_hash_exact"], abs_err(u32(out), u32(plain)))
        check_digests(u32(out), leaves, f"leaf_hash_exact nblocks={nb}")
    print(f"leaf_hash_exact: nblocks 1..8 x 3000 leaves, max |kernel - plain| = {err['leaf_hash_exact']}")

    # K4: long leaves, 600 B .. 64 KB, every stream bucket they land in.
    lengths = np.concatenate([rng.integers(600, 641, 8), rng.integers(1000, 1101, 8), rng.integers(8000, 8193, 8),
                              rng.integers(32000, 32769, 4), rng.integers(65000, 65537, 4)])
    leaves = rand_leaves(lengths)
    packed = pack_spans(*spans_of(leaves), max_device_blocks=2048)
    check(all(b.counts is not None for b in packed.buckets) and packed.host_spans is None,
          "600 B..64 KB leaves should all land in stream buckets")
    got = lh.leaf_hashes(packed, dev)
    torch.cuda.synchronize()
    for b in packed.buckets:
        plain = lh.stream_hash_plain(lh.to_device_words(b.words, "cpu"), torch.from_numpy(b.counts), b.count)
        kern = torch.empty((8, b.count), dtype=torch.int32, device=dev)
        lh.stream_hash_into(lh.to_device_words(b.words, dev), torch.from_numpy(b.counts).to(dev),
                            b.nblocks, b.count, kern, 0)
        err["leaf_hash_stream"] = max(err["leaf_hash_stream"], abs_err(u32(kern), u32(plain)))
    check_digests(u32(got), leaves, "leaf_hash_stream")
    print(f"leaf_hash_stream: {len(leaves)} leaves of 600 B..64 KB in {len(packed.buckets)} buckets,"
          f" max |kernel - plain| = {err['leaf_hash_stream']}")

    # K2: one level of 2^14 digests, flat and grouped; also on a column range.
    x_cpu = torch.from_numpy(rng.integers(0, 2**32, size=(8, 1 << 14), dtype=np.uint32).view(np.int32))
    x_dev = x_cpu.to(dev)
    xs = u32(x_cpu)
    for groups in (1, 4, 64):
        got = u32(tr.fold_level(x_dev, groups))
        err["fold_level"] = max(err["fold_level"], abs_err(got, u32(tr.fold_level_plain(x_cpu, groups))))
        m = (1 << 14) // groups
        for i in rng.integers(0, 1 << 13, size=64):
            g, j = divmod(int(i), m // 2)
            left, right = xs[:, g * m + j], xs[:, g * m + m // 2 + j]
            check(words_to_digest(got[:, i]) == oracle.node_hash(words_to_digest(left), words_to_digest(right)),
                  f"fold_level groups={groups}: node {i} differs from hashlib")
    sub = u32(tr.fold_level(x_dev[:, 4096:8192]))
    err["fold_level"] = max(err["fold_level"], abs_err(sub, u32(tr.fold_level_plain(x_cpu[:, 4096:8192]))))
    print(f"fold_level: 2^14 digests, groups 1/4/64 and a column range, max |kernel - plain| = {err['fold_level']}")

    # K3: n = 1, 2, 4, ..., 1024 bit-reversed digests to the root, one block
    # a launch; then every perfect block of the 12345-digest ragged tail in
    # one launch (two of them folded to 1024 digests by K2 first).
    for k in range(11):
        n = 1 << k
        nat = xs[:, :n]
        fold_in = torch.from_numpy(np.ascontiguousarray(nat[:, bit_reverse_indices(k)]).view(np.int32))
        root = u32(tr.tail_reduce(fold_in.to(dev)))
        err["tail_reduce"] = max(err["tail_reduce"], abs_err(root, u32(tr.tail_reduce_plain(fold_in))))
        want = oracle.merkle_root_of_digests([words_to_digest(nat[:, i]) for i in range(n)])
        check(words_to_digest(root) == want, f"tail_reduce n={n}: root differs from hashlib")
    ragged_nat = np.random.default_rng(SEED + RAGGED).integers(0, 2**32, size=(8, RAGGED), dtype=np.uint32)
    ragged_dev = torch.from_numpy(ragged_nat.view(np.int32)).to(dev)
    ragged, ragged_heights = tr.ragged_entries(ragged_dev, RAGGED)
    _build.reset_counts()
    got = u32(tr.tail_reduce_blocks(ragged))
    check(dict(_build.launches) == {"tail_reduce": 1}, f"the ragged tail's blocks took {dict(_build.launches)}")
    cpu_blocks = [e._replace(cols=e.cols.cpu()) for e in ragged]
    err["tail_reduce"] = max(err["tail_reduce"], abs_err(got, u32(tr.tail_reduce_blocks_plain(cpu_blocks))))
    raw = [words_to_digest(ragged_nat[:, i]) for i in range(RAGGED)]
    start = 0
    for row, k in zip(got, ragged_heights):
        check(words_to_digest(row) == oracle.merkle_root_of_digests(raw[start : start + (1 << k)]),
              f"tail_reduce_blocks: the root of block 2^{k} at {start} differs from hashlib")
        start += 1 << k
    check(tr.slice_root(ragged_dev, RAGGED, 14) == oracle.reduce_slice(raw, 14), "ragged slice root != hashlib")
    print(f"tail_reduce: n = 1..1024 one block a launch; the {RAGGED}-digest ragged tail's {len(ragged)} blocks"
          f" (2^{', 2^'.join(map(str, ragged_heights))}) in one launch; max |kernel - plain| = {err['tail_reduce']}")
    check(not any(err.values()), f"kernels disagree with their plain versions: {err}")

    # Times at the main path's shapes: one 2^16-leaf flush of each engine
    # stream, packed bit-reversed as the engine packs a full group (the rndm
    # flush: exact buckets; the flush with one leaf in 64 of 1-8 KB: its
    # stream rungs), a 2^20-digest grouped slice's first level (16 groups),
    # its 16-root tail and a 1024-digest tail.  K1 and K4 are timed in turns
    # (bucket by bucket through the one-bucket wrappers, one launch per
    # bucket; the flush in one launch; one launch; bucket by bucket), and K4
    # also on one 64-block leaf alone, its chain floor.  The plain version
    # runs on the same card tensors, and each kernel's last result must equal
    # the plain one byte for byte.
    phase("kernels at the main path's shapes (ms per call, CUDA events)")
    flush = native_rndm_stream(SEED, 1 << 16, 127)
    data, offs, lens = split_lines(flush)
    perm = bit_reverse_indices(16)
    fpacked = pack_spans(data, offs[perm], lens[perm], 2048)
    fexact, _ = lh.flush_buckets(fpacked, dev)
    check(all(b.counts is None for b in fpacked.buckets) and fpacked.host_spans is None,
          "a 1-127 B flush should pack into exact buckets only")

    big = [rng.integers(32, 127, size=int(n), dtype=np.uint8).tobytes() for n in rng.integers(1024, 8193, 1024)]
    lines = flush.split(b"\n")[:-1]
    for i, leaf in enumerate(big):
        lines[64 * i] = leaf
    data2, offs2, lens2 = spans_of(lines)
    spacked = pack_spans(data2, offs2[perm], lens2[perm], 2048)
    _, srungs = lh.flush_buckets(spacked, dev)
    check(len(srungs) >= 2 and spacked.host_spans is None, "the 1-8 KB leaves should pack into stream rungs")
    one = spans_of([rng.integers(32, 127, size=64 * 64 - 9, dtype=np.uint8).tobytes()])
    (lone,) = lh.flush_buckets(pack_spans(*one), dev)[1]
    lout = torch.empty((8, 1), dtype=torch.int32, device=dev)

    def by_bucket(buckets, out, exact: bool):
        def run():
            for b in buckets:
                if exact:
                    lh.exact_hash_into(b.words, b.nblocks, b.count, out, b.col)
                else:
                    lh.stream_hash_into(b.words, b.counts, b.nblocks, b.count, out, b.col)
            return out
        return run

    def one_launch(buckets, out, exact: bool):
        def run():
            (lh.exact_hash_buckets_into if exact else lh.stream_hash_buckets_into)(buckets, out)
            return out
        return run

    def plain_of(buckets, n: int, exact: bool):
        def run():
            out = torch.empty((8, n), dtype=torch.int32, device=dev)
            for b in buckets:
                out[:, b.col : b.col + b.count] = (lh.exact_hash_plain(b.words, b.nblocks, b.count) if exact
                                                    else lh.stream_hash_plain(b.words, b.counts, b.count))
            return out
        return run

    n_stream = sum(b.count for b in srungs)

    def cols_of(t: torch.Tensor, buckets) -> np.ndarray:
        """The buckets' columns of an (8, n) digest tensor."""
        a = u32(t)
        return np.concatenate([a[:, b.col : b.col + b.count] for b in buckets], axis=1)
    flush_shapes = {
        "leaf_hash_exact": (fexact, True, 1 << 16,
                            f"2^16-leaf rndm flush, {len(fexact)} exact buckets ({', '.join(f'{b.count} x {b.nblocks}' for b in fexact)})"),
        "leaf_hash_stream": (srungs, False, 1 << 16,
                             f"stream-2 flush, {len(srungs)} rungs, {n_stream} leaves, caps"
                             f" {min(b.nblocks for b in srungs)}..{max(b.nblocks for b in srungs)}"),
    }
    # Each turn writes an output of its own, filled with -1 first, so a
    # column that a launch pattern skips cannot keep another turn's digest.
    # The first one-launch turn's output is the one held against the plain
    # version and hashlib below.
    ms, plain_ms, per_bucket_ms, work, kept = {}, {}, {}, {}, {}
    for name, (buckets, exact, n, shape) in flush_shapes.items():
        turns, per_bucket = [], None
        for kind in ("bucket by bucket", "one launch", "one launch", "bucket by bucket"):
            out = torch.full((8, n), -1, dtype=torch.int32, device=dev)
            fn = by_bucket(buckets, out, exact) if kind == "bucket by bucket" else one_launch(buckets, out, exact)
            t, _ = cuda_ms(fn, 20)
            turns.append((kind, t))
            ref = cols_of(out, buckets)
            check(not (ref == 0xFFFFFFFF).all(axis=0).any(), f"{name}: {kind} left columns unwritten")
            if per_bucket is None:
                per_bucket = ref
            check(np.array_equal(ref, per_bucket), f"{name}: one launch differs from bucket by bucket")
            if kind == "one launch":
                kept.setdefault(name, out)
        ms[name] = (turns[1][1] + turns[2][1]) / 2
        per_bucket_ms[name] = (turns[0][1] + turns[3][1]) / 2
        print(f"{name:17s} {shape}: in turns " + ", ".join(f"{k} {t:.4f}" for k, t in turns) + " ms")
        if exact:
            blocks = sum(b.count * b.nblocks for b in buckets)
            work[name] = dict(blocks=blocks, leaves=n, bytes=blocks * 64 + 32 * n)
        else:
            blocks = int(sum(int(b.counts[: b.count].sum()) for b in buckets))
            work[name] = dict(blocks=blocks, leaves=n_stream, bytes=blocks * 64 + 36 * n_stream)
    # K1 on four flushes' worth of the same stream in one launch: how the
    # fraction of the bound grows once the launch is more than one wave.
    quad = native_rndm_stream(SEED + 1, 1 << 18, 127)
    qpacked = pack_spans(*split_lines(quad), 2048)
    qexact, _ = lh.flush_buckets(qpacked, dev)
    qout = torch.empty((8, 1 << 18), dtype=torch.int32, device=dev)
    t_quad, _ = cuda_ms(one_launch(qexact, qout, True), 20)
    qblocks = sum(b.count * b.nblocks for b in qexact)
    work["leaf_hash_exact 2^18"] = dict(blocks=qblocks, leaves=1 << 18, bytes=qblocks * 64 + 32 * (1 << 18))
    print(f"{'leaf_hash_exact':17s} 2^18 rndm leaves, {len(qexact)} exact buckets, one launch: {t_quad:.4f} ms")
    # K1's compact wire form on the same flush as the engine sends it: the
    # pass's row table and raw bytes, copied once from a page-locked slot,
    # each digest written at its group-bit-reversed column; byte-exact
    # against its plain version and hashlib.
    wslot = lh.WireSlot(dev)
    wcols = FlushColumns(0, perm)
    wunit, wire = pack_flush([(data, offs, lens)], wcols, 2048, wslot)
    check(wire, "the 2^16-leaf rndm flush should take the compact wire")
    wout = torch.full((8, 1 << 16), -1, dtype=torch.int32, device=dev)
    wtable, wctas = lh.wire_tables(wunit, wslot.upload(wunit.nbytes, dev), wout)

    def wire_launch():
        _build.launch("leaf_hash_exact", "vkmr_leaf_hash_wire", ctypes.addressof(wtable), wctas,
                      _build.stream_of(wout))
        return wout

    ms["leaf_hash_wire"], _ = cuda_ms(wire_launch, 20)
    wblocks = sum(int(r) * b for b, r in enumerate(wunit.rows, 1))
    work["leaf_hash_wire"] = dict(blocks=wblocks, leaves=1 << 16, bytes=wunit.nbytes + 32 * (1 << 16))
    wplain = torch.full((8, 1 << 16), -1, dtype=torch.int32)
    lh.wire_hash_plain(wunit, wplain)
    err["leaf_hash_exact"] = max(err["leaf_hash_exact"], abs_err(u32(wout), u32(wplain)))
    wdest, wleaves = wcols.of(1 << 16), flush.split(b"\n")[:-1]
    for j in rng.integers(0, 1 << 16, size=256):
        check(words_to_digest(u32(wout)[:, wdest[j]]) == oracle.leaf_hash(wleaves[j]),
              f"leaf_hash_exact wire form: leaf {j} differs from hashlib")
    print(f"{'leaf_hash_exact':17s} wire form, the same flush grouped ({wunit.nbytes} B in one copy against"
          f" {sum(b.words.nbytes for b in fpacked.buckets)} B of packed words): {ms['leaf_hash_wire']:.4f} ms;"
          f" max |kernel - plain| = {abs_err(u32(wout), u32(wplain))}")
    t_lone, got = cuda_ms(one_launch([lone], lout, False), 20)
    check(words_to_digest(u32(got)[:, 0]) == oracle.leaf_hash(bytes(one[0])), "K4 on one 64-block leaf != hashlib")
    longest = max(int(b.counts[: b.count].max()) for b in srungs)
    t_comp = t_lone / 65  # ms a compression of one warp alone
    print(f"{'leaf_hash_stream':17s} one 64-block leaf alone (the chain floor of 65 compressions): {t_lone:.4f} ms,"
          f" {t_comp * 1e3:.3f} us a compression; the stream flush's longest leaf has {longest} blocks:"
          f" chain floor {(longest + 1) * t_comp:.4f} ms")

    slice_dev = torch.from_numpy(rng.integers(0, 2**32, size=(8, 1 << 20), dtype=np.uint32).view(np.int32)).to(dev)
    roots16 = [tr.TailEntry(slice_dev[:, :16].contiguous(), 4, False)]  # a full slice's group roots
    roots1024 = slice_dev[:, :1024].contiguous()
    timings = {
        "fold_level": (lambda: tr.fold_level(slice_dev, 16), lambda: tr.fold_level_plain(slice_dev, 16),
                       "2^20 -> 2^19 digests, 16 groups"),
        "tail_reduce": (lambda: tr.tail_reduce_blocks(roots16), lambda: tr.tail_reduce_blocks_plain(roots16),
                        "16 natural-order group roots -> root"),
    }
    work["fold_level"] = dict(nodes=1 << 19, bytes=(1 << 20) * 32 + (1 << 19) * 32)
    work["tail_reduce"] = dict(nodes=15, levels=4, bytes=17 * 32)
    last = {}
    for name, (kern, plain, shape) in timings.items():
        ms[name], last[name] = cuda_ms(kern, 20)
        print(f"{name:17s} {shape:40s} kernel {ms[name]:.4f} ms")
    t1024, got1024 = cuda_ms(lambda: tr.tail_reduce(roots1024), 20)
    print(f"{'tail_reduce':17s} {'1024 bit-reversed digests -> root':40s} kernel {t1024:.4f} ms")

    # The ragged tail of stream 1, its two large blocks folded to 1024 digests
    # by K2 beforehand: K3 block by block (the wrapper's one-block table, one
    # launch a block, PR 4's pattern) and every block in one launch, in turns,
    # each turn into an output of its own filled with -1.  Then the tail's
    # whole device part (ragged_entries: the gathers and K2 levels of its
    # blocks over 1024 digests, then one K3 launch), with the host's enqueue
    # time.
    def tail_launches(out, per_block: bool):
        tables = ([t for k, e in enumerate(ragged) for t in tr.tail_tables([e], out[k : k + 1])] if per_block
                  else tr.tail_tables(ragged, out))

        def run():
            for table in tables:
                _build.launch("tail_reduce", "vkmr_tail_reduce", ctypes.addressof(table), _build.stream_of(out))
            return out
        return run

    tail_turns, want_rows = [], u32(tr.tail_reduce_blocks(ragged))
    for kind in ("block by block", "one launch", "one launch", "block by block"):
        out = torch.full((len(ragged), 8), -1, dtype=torch.int32, device=dev)
        t, _ = cuda_ms(tail_launches(out, kind == "block by block"), 20)
        tail_turns.append((kind, t))
        check(np.array_equal(u32(out), want_rows), f"tail_reduce: the ragged tail {kind} differs")
    ms["tail_reduce ragged"] = (tail_turns[1][1] + tail_turns[2][1]) / 2
    per_bucket_ms["tail_reduce"] = (tail_turns[0][1] + tail_turns[3][1]) / 2
    print(f"{'tail_reduce':17s} {RAGGED}-digest ragged tail, K3 alone: in turns "
          + ", ".join(f"{k} {t:.4f}" for k, t in tail_turns) + " ms")

    def whole_tail():
        return tr.tail_reduce_blocks(tr.ragged_entries(ragged_dev, RAGGED)[0])

    (t, host), got = timed_with_host(whole_tail, 10), whole_tail()
    check(np.array_equal(u32(got), want_rows), "ragged tail, one K3 launch: block roots differ")
    print(f"{'tail_reduce':17s} {RAGGED}-digest ragged tail's device part (gathers, K2, one K3 launch):"
          f" {t:.4f} ms on the card, {host:.4f} ms of host enqueue")

    # A full grouped slice reduces without a gather: the group levels, then
    # the 16 natural-order group roots straight into K3.
    gathers, index_select = [], torch.Tensor.index_select

    def counted(self, *args, **kwargs):
        gathers.append(1)
        return index_select(self, *args, **kwargs)

    _build.reset_counts()
    torch.Tensor.index_select = counted
    try:
        grouped_root = u32(tr.reduce_grouped_body(slice_dev, 20, 16))
    finally:
        torch.Tensor.index_select = index_select
    grouped_launches = dict(_build.launches)
    check(not gathers and grouped_launches == {"fold_level": 16, "tail_reduce": 1},
          f"a grouped slice's reduction ran {len(gathers)} gathers and {grouped_launches}")
    other_route = u32(tr.reduce_perfect_block(tr.group_bitrev_to_natural(slice_dev, 20, 16), 20))
    check(np.array_equal(grouped_root, other_route), "grouped slice root differs from the natural-order route")
    print(f"reduce_grouped_body, 2^20 digests in 16 groups: {grouped_launches}, no gather; root equals the"
          f" natural-order route's")

    # K3 once on each of eight shapes against the plain version: 1 to 1024
    # bit-reversed digests, a full slice's 16 natural-order group roots and
    # the ragged tail.
    shape_rng = np.random.default_rng(SEED)

    def digests(n: int) -> torch.Tensor:
        return torch.from_numpy(shape_rng.integers(0, 2**32, size=(8, n), dtype=np.uint32).view(np.int32)).to(dev)

    k3_shapes = [[tr.TailEntry(digests(1 << k), k, True)] for k in (0, 1, 4, 7, 8, 10)]
    k3_shapes += [[tr.TailEntry(digests(16), 4, False)], tr.ragged_entries(digests(RAGGED), RAGGED)[0]]
    for entries in k3_shapes:
        e = abs_err(u32(tr.tail_reduce_blocks(entries)),
                    u32(tr.tail_reduce_blocks_plain([x._replace(cols=x.cols.cpu()) for x in entries])))
        err["tail_reduce"] = max(err["tail_reduce"], e)
    print(f"tail_reduce on {len(k3_shapes)} shapes (1 to 1024 bit-reversed digests, 16 natural-order group roots,"
          f" the {RAGGED}-digest ragged tail): max |kernel - plain| = {err['tail_reduce']}")
    # The plain versions run after every kernel is timed: seconds of small
    # launches leave the SM clock low for a while after them.
    for name, (buckets, exact, n, shape) in flush_shapes.items():
        plain_ms[name], want = cuda_ms(plain_of(buckets, n, exact), 1, warm=False, plain=True)
        e = abs_err(cols_of(kept[name], buckets), cols_of(want, buckets))
        err[name] = max(err[name], e)
        print(f"{name:17s} plain on the flush {plain_ms[name]:.2f} ms; max |kernel - plain| = {e}")
    for name, (kern, plain, shape) in timings.items():
        plain_ms[name], want = cuda_ms(plain, 2, plain=True)
        e = abs_err(u32(last[name]), u32(want))
        err[name] = max(err[name], e)
        print(f"{name:17s} {shape:40s} plain {plain_ms[name]:.2f} ms, max |kernel - plain| = {e}")
    e = abs_err(u32(got1024), u32(tr.tail_reduce_plain(roots1024)))
    err["tail_reduce"] = max(err["tail_reduce"], e)
    print(f"{'tail_reduce':17s} {'1024 digests -> root':40s} max |kernel - plain| = {e}")
    check(not any(err.values()), f"kernels disagree with their plain versions at the main path's shapes: {err}")
    # Packed column c of a flush holds input leaf perm[order[c]].
    stream_cols = np.concatenate([np.arange(b.col, b.col + b.count) for b in srungs])
    for name, (packed, leaves, picks) in {
        "leaf_hash_exact": (fpacked, flush.split(b"\n")[:-1], rng.integers(0, 1 << 16, size=256)),
        "leaf_hash_stream": (spacked, lines, stream_cols),
    }.items():
        cols = u32(kept[name])
        for c in picks:
            check(words_to_digest(cols[:, c]) == oracle.leaf_hash(leaves[perm[packed.order[c]]]),
                  f"{name}: flush column {c} differs from hashlib")

    # -- 4. the streaming engine ------------------------------------------------
    phase("engine: CudaSha256D, slice_log2=20, batch_leaves=2^16")
    n1 = (1 << 21) + 12345
    stream1 = native_rndm_stream(SEED, n1, 127)
    stream2 = b"\n".join(lines * 16) + b"\n"  # 2^20 leaves, one in 64 of 1-8 KB
    streams = [(f"rndm {SEED} {n1} 127", stream1, n1), ("rndm 2^20 x 127 B, 1 in 64 leaves 1-8 KB", stream2, 1 << 20)]
    launches, plain_calls = {}, {}
    for title, stream, count in streams:
        ref = CpuSha256D()
        ref.AddSpans(*split_lines(stream))
        want = ref.Root()
        _build.reset_counts()
        engine = CudaSha256D(device=dev, config=EngineConfig(slice_log2=20, batch_leaves=1 << 16))
        nbytes = 0
        t0 = time.perf_counter()
        for d, o, ln in iter_line_spans(io.BytesIO(stream)):
            check(engine.AddSpans(d, o, ln), f"{title}: AddSpans refused")
            nbytes += int(ln.sum())
        root = engine.Root()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches, run_plain = dict(_build.launches), dict(_build.plain_calls)
        stats = engine.Stats()
        flushes = stats["stages"]["map_dispatch"]["count"]
        check(stats["leaves"] == count, f"{title}: engine counted {stats['leaves']} leaves, want {count}")
        for name in ("leaf_hash_exact", "leaf_hash_stream"):
            check(run_launches.get(name, 0) <= flushes,
                  f"{title}: {run_launches.get(name, 0)} {name} launches for {flushes} flushes")
        check(root == want, f"{title}: engine root {root} != native host root {want}")
        tail_on_card = count % (1 << 20) > engine.config.host_tail_leaves
        k3 = run_launches.get("tail_reduce", 0)
        check(k3 == stats["slices_completed"] + tail_on_card,
              f"{title}: {k3} tail_reduce launches for {stats['slices_completed']} full slices"
              f" and {'a' if tail_on_card else 'no'} ragged tail on the card")
        print(f"{title}: root {root[:16]}... == host root; {count / wall:,.0f} leaves/s,"
              f" {nbytes / wall / 1e9:.3f} GB/s payload, {wall:.3f} s wall;"
              f" {stats['slices_completed']} full slices")
        print(f"  K3 launches: {k3}, one a full slice" + (", one for the ragged tail" if tail_on_card else ""))
        print("  stages:", json.dumps(stats["stages"]))
        print(f"  launches: {run_launches} for {flushes} packed flushes ("
              + ", ".join(f"{name} {n / flushes:.3f}" for name, n in sorted(run_launches.items()))
              + f" per flush); plain calls: {run_plain}")
        for name, n in run_launches.items():
            launches[name] = launches.get(name, 0) + n
        for name, n in run_plain.items():
            plain_calls[name] = plain_calls.get(name, 0) + n
    print(f"launches on the main path: {launches}; plain calls: {plain_calls}")
    for name in err:
        check(launches.get(name, 0) > 0, f"kernel {name} never launched on the main path")
    check(not plain_calls, f"plain PyTorch paths ran on the card: {plain_calls}")

    # -- 5. the CLI ------------------------------------------------------------
    phase("CLI: python -m vk_merkle_roots_tpu_torch.cli (GPU auto-selected)")
    for count, want_prefix in ((1024, "050194bb"), ((1 << 22) + 3, None)):
        stream = native_rndm_stream(SEED, count, 127)
        ref = CpuSha256D()
        ref.AddSpans(*split_lines(stream))
        want = ref.Root()
        if want_prefix:
            check(want == oracle.merkle_root(stream.split(b"\n")[:-1]).hex(), "native root != oracle root")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "vk_merkle_roots_tpu_torch.cli", "--stats"], input=stream,
                              capture_output=True, cwd=REPO, timeout=900)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI exited {proc.returncode}: {proc.stderr.decode()[-3000:]}")
        out = proc.stdout.decode()
        root = out.split("=> ")[1].split(" ")[0]
        stats = json.loads(proc.stderr.decode().strip().splitlines()[-1])
        check(root == want, f"CLI root {root} != host root {want}")
        if want_prefix:
            check(root.startswith(want_prefix), f"canonical root {root} does not begin {want_prefix}")
        else:
            check(stats["slice_log2"] == 23, f"auto slice gave 2^{stats['slice_log2']}, want 2^23 on this card")
        print(f"rndm {SEED} {count} 127: {out.strip().splitlines()[-1]}")
        print(f"  == host root; slice 2^{stats['slice_log2']}, {stats['slices_completed']} full slices;"
              f" {wall:.2f} s including process start and kernel load")

    # -- 6. the roofline and the batch API --------------------------------------
    phase("roofline and batch API: K5/K6, SASS counts, the perf model, merkle_root_device, fused step, entry()")
    probes = {"alu_probe": (pp.alu_probe, pp.alu_probe_plain, pp.ALU_PROBE_SEED),
              "rot_probe": (pp.rot_probe, pp.rot_probe_plain, pp.ROT_PROBE_SEED)}
    for name, (kern, plain, seed) in probes.items():
        x1 = torch.from_numpy(pp.probe_input(seed, 1).view(np.int32))
        err[name] = abs_err(u32(kern(x1.to(dev))), u32(plain(x1)))
        x256 = torch.from_numpy(pp.probe_input(seed, 256).view(np.int32)).to(dev)
        ms[name], got = cuda_ms(lambda: kern(x256), 20)
        plain_ms[name], want = cuda_ms(lambda: plain(x256), 2, plain=True)
        e = abs_err(u32(got), u32(want))
        err[name] = max(err[name], e)
        print(f"{name:17s} {'1 tile on CPU copies; 256 tiles':40s} kernel {ms[name]:.4f} ms, plain {plain_ms[name]:.2f} ms,"
              f" max |kernel - plain| = {err[name]}")
    check(not err["alu_probe"] and not err["rot_probe"], f"probes disagree with their plain versions: {err}")

    sass = pp.sass_counts()
    for name, c in sass.items():
        top = ", ".join(f"{op} {n}" for op, n in list(c["by_opcode"].items())[:6])
        loop = c["loop"]
        print(f"SASS {name:17s} {c['total']:6d} instructions, {c['integer']:6d} integer ({top})"
              + (f"; pass loop {loop['total']} ({loop['integer']} integer: {json.dumps(loop['by_opcode'])})"
                 if loop and name in probes else ""))
    for name in probes:
        check(sass[name]["loop"] is not None, f"{name}: no pass loop found in its SASS")
    alu_loop_int = sass["alu_probe"]["loop"]["integer"]
    check(alu_loop_int >= pp.PROBE_ROUNDS // 2,
          f"alu_probe's pass loop holds {alu_loop_int} integer instructions, under {pp.PROBE_ROUNDS // 2}: folded")

    _build.reset_counts()
    model = perf_model.perf_model(dev)
    roofline_launches, roofline_plain = dict(_build.launches), dict(_build.plain_calls)
    print("perf model:", json.dumps(model))
    print(f"launches in the perf model's run: {roofline_launches}; plain calls: {roofline_plain}")
    for name in ("alu_probe", "rot_probe", "leaf_hash_exact", "fold_level", "tail_reduce"):
        check(roofline_launches.get(name, 0) > 0, f"kernel {name} never launched in the perf model's run")
    check(not roofline_plain, f"plain PyTorch paths ran in the perf model: {roofline_plain}")
    for key in ("mapping", "reduction"):
        f = model[key]["fraction_of_probe_ceiling"]
        check(np.isfinite(f) and f > 0, f"{key}: fraction_of_probe_ceiling {f}")
    check(np.isfinite(model["reduction"]["sass_fraction_of_probe_issue"]), "no SASS view of K2")
    check(np.isfinite(model["reduction"]["alu_pipe_fraction_of_rot_probe_issue"]), "no ALU-pipe view of K2")
    for name in probes:
        p = model[name]
        print(f"{name}: {p['lane_ops_per_sec']['median']:.4e} nominal lane-ops/s,"
              f" {p['sass_instructions_per_sec']['median']:.4e} SASS/s at SM clock {p['sm_clock_MHz']['median']:.0f}"
              f" MHz {{{p['sm_clock_MHz']['min']:.0f}-{p['sm_clock_MHz']['max']:.0f}, n={p['sm_clock_MHz']['n']}}}"
              f" (max {model['card']['max_sm_clock_MHz']:.0f}) = {p['sass_lanes_per_clock_per_sm']:.2f}"
              f" SASS lanes/clock/SM over {model['card']['sms']} SMs")
    print(f"rotate_fusion_ratio {model['rotate_fusion_ratio']:.4f}; mapping fraction"
          f" {model['mapping']['fraction_of_probe_ceiling']:.4f}, reduction fraction"
          f" {model['reduction']['fraction_of_probe_ceiling']:.4f} (SASS view"
          f" {model['reduction']['sass_fraction_of_probe_issue']:.4f}, ALU-pipe view"
          f" {model['reduction']['alu_pipe_fraction_of_rot_probe_issue']:.4f}); {smi}")

    _build.reset_counts()
    n_batch = 1 << 20
    stream = native_rndm_stream(SEED, n_batch, 127)
    ref = CpuSha256D()
    ref.AddSpans(*split_lines(stream))
    want = ref.Root()
    t0 = time.perf_counter()
    root = merkle.merkle_root_device(stream.split(b"\n")[:-1], dev).hex()
    wall = time.perf_counter() - t0
    check(root == want, f"merkle_root_device: {root} != native host root {want}")
    print(f"merkle_root_device, rndm {SEED} {n_batch} 127: root {root[:16]}... == host root; {wall:.3f} s wall")
    ex_leaves = merkle.example_leaves(1 << 14, 64, 1)
    ref = CpuSha256D()
    ref.AddMany(ex_leaves)
    want = ref.Root()
    step = merkle.fused_root_fn(1 << 14, 2, dev)
    words = lh.to_device_words(merkle.example_words(1 << 14, 64, 1), dev)
    step_ms, got = cuda_ms(lambda: step(words), 20)
    check(tr.words_to_bytes(got).hex() == want, "fused step root != native host root")
    fn, (entry_words,) = entry()
    check(tr.words_to_bytes(fn(entry_words)).hex() == want, "entry() root != native host root")
    batch_launches, batch_plain = dict(_build.launches), dict(_build.plain_calls)
    print(f"fused step and entry(), 2^14 x 64 B: root {want[:16]}... == host root; step {step_ms:.4f} ms")
    print(f"launches in the batch API's run: {batch_launches}; plain calls: {batch_plain}")
    for name in ("leaf_hash_exact", "fold_level", "tail_reduce"):
        check(batch_launches.get(name, 0) > 0, f"kernel {name} never launched in the batch API's run")
    check(not batch_plain, f"plain PyTorch paths ran in the batch API: {batch_plain}")

    t0 = time.perf_counter()
    kdebug = subprocess.run([sys.executable, "-c", KDEBUG_CHILD], cwd=REPO, text=True, capture_output=True,
                            env=dict(os.environ, VKMR_KERNEL_DEBUG="1"), timeout=600)
    kdebug_out = kdebug.stdout
    tags = [line for line in kdebug_out.splitlines() if line.startswith("leaf_kernel d0[lane0] = ")]
    # Device printf reaches the process's C stdout buffer, flushed at exit,
    # so the tags may follow the child's own line.
    summary = next((line.split() for line in kdebug_out.splitlines() if line.startswith("library ")), [])
    check(kdebug.returncode == 0 and len(summary) == 4,
          f"VKMR_KERNEL_DEBUG=1 process failed (exit {kdebug.returncode}): {kdebug.stderr[-3000:]}")
    check(summary[1] != _build.library_path().name, "the debug run loaded the library without the hook")
    check(len(tags) == 8 and f"leaf_kernel d0[lane0] = {summary[3]}" in tags,
          f"K1 with VKMR_KERNEL_DEBUG=1 printed {tags}, want 8 CTA tags incl. leaf 0's word {summary[3]}")
    print(f"VKMR_KERNEL_DEBUG=1: {summary[1]}, K1 printed {len(tags)} CTA tags, first {tags[0]!r};"
          f" {time.perf_counter() - t0:.2f} s with its build")

    # -- 7. journal, resume and proofs ------------------------------------------
    phase("journal, resume and proofs on the card: slice 2^20, batch 2^16")
    t0 = time.perf_counter()
    journal_phase(dev, smi, streams)
    print(f"journal phase {time.perf_counter() - t0:.1f} s wall")

    # -- 8. multi-device and multi-process ----------------------------------------
    phase("multi-device: MESH, sharded reduce, multi-process")
    t0 = time.perf_counter()
    multi_device_phase(smi, stream1, cuda_ms)
    print(f"multi-device phase {time.perf_counter() - t0:.1f} s wall")

    # -- 9. randomized differential ----------------------------------------------
    phase("randomized differential: 48 seeded engine trials on the card")
    t0 = time.perf_counter()
    randomized_phase(smi)
    print(f"randomized differential phase {time.perf_counter() - t0:.1f} s wall")

    # -- 10. result ------------------------------------------------------------
    phase("result")
    launches.update({name: roofline_launches[name] for name in probes})
    replaces = {
        "leaf_hash_exact": ("leaf_hash.cu", "vk_merkle_roots_tpu/ops/leaf_hash.py:61"),
        "leaf_hash_stream": ("leaf_hash.cu", "vk_merkle_roots_tpu/ops/leaf_hash.py:129"),
        "fold_level": ("tree_reduce.cu", "vk_merkle_roots_tpu/ops/tree_reduce.py:91"),
        "tail_reduce": ("tail_reduce.cuh", "vk_merkle_roots_tpu/ops/tree_reduce.py:157"),
        "alu_probe": ("perf_probe.cu", "vk_merkle_roots_tpu/ops/perf_probe.py:117"),
        "rot_probe": ("perf_probe.cu", "vk_merkle_roots_tpu/ops/perf_probe.py:188"),
    }
    # The least time for each timed call: its integer ALU-pipe instructions
    # (SHF, LOP3, IADD3 from the kernel's SASS, weighted by this run's trip
    # counts) over 64 lanes a clock on each SM at the card's maximum SM clock
    # (for K3 and K4 a chain, if longer), or its bytes (each input
    # read once, each output written once) over 3.35 TB/s, whichever is
    # longer.
    clock_mhz = float(perf_model._smi("clocks.max.sm")[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    alu_rate = 64 * sms * clock_mhz * 1e6

    def alu(c) -> int:
        return sum(c["by_opcode"].get(op, 0) for op in perf_model.ALU_PIPE_OPCODES)

    for name in ("leaf_hash_exact", "leaf_hash_wire", "leaf_hash_stream"):
        check(sass[name]["loop"] is not None, f"{name}: no block loop found in its SASS")
    node_alu = alu(sass["fold_level"])
    ops = {}
    for name in ("leaf_hash_exact", "leaf_hash_wire", "leaf_hash_stream", "leaf_hash_exact 2^18"):
        # K1's block loop holds two compressions (a register buffer each), its
        # wire form's and K4's one; the rest of the kernel is the finalization
        # compression and the addressing, once a leaf.
        kernel = name.split()[0]
        per_loop = 2 if kernel == "leaf_hash_exact" else 1
        loop_alu, rest_alu = alu(sass[kernel]["loop"]), alu(sass[kernel]) - alu(sass[kernel]["loop"])
        ops[name] = work[name]["blocks"] * loop_alu / per_loop + work[name]["leaves"] * rest_alu
        print(f"{name}: {loop_alu / per_loop:.0f} ALU-pipe instructions a compression, {rest_alu} a leaf besides"
              f" (K2: {node_alu} a node of three compressions)")
    ms["leaf_hash_exact 2^18"] = t_quad
    ops["fold_level"] = work["fold_level"]["nodes"] * node_alu
    ops["tail_reduce"] = work["tail_reduce"]["nodes"] * node_alu
    # K3 is bound by the chain of its levels: a level is one node hash on the
    # warp that runs its rounds (K3's longest SASS loop), and a lone warp
    # issues at best one instruction every second clock; its ALU-pipe
    # instructions at that rate, at the card's maximum SM clock.
    check(sass["tail_reduce"]["loop"] is not None, "tail_reduce: no level loop found in its SASS")
    level_alu = alu(sass["tail_reduce"]["loop"])
    level_ms = level_alu * 2 / (clock_mhz * 1e6) * 1e3
    chain = {"tail_reduce": work["tail_reduce"]["levels"] * level_ms, "1024 digests": 10 * level_ms,
             f"{RAGGED}-digest ragged tail": max(e.log2n for e in ragged) * level_ms}
    ms["1024 digests"], ms[f"{RAGGED}-digest ragged tail"] = t1024, ms["tail_reduce ragged"]
    for shape, t in chain.items():
        print(f"tail_reduce chain bound, {shape}: {t / level_ms:.0f} levels x {level_alu} ALU-pipe instructions of the"
              f" round warp x 2 clocks at {clock_mhz:.0f} MHz = {t:.5f} ms; kernel {ms[shape]:.4f} ms,"
              f" {t / ms[shape]:.3f} of it")
    print(f"tail_reduce ragged tail: block by block {per_bucket_ms["tail_reduce"]:.4f} ms, one launch"
          f" {ms['tail_reduce ragged']:.4f} ms")
    # K4 is bound by the chain of its longest leaf: its compressions, and the
    # finalization's, one after another on one lane.  Only a compression's
    # rounds lie on that chain (the message schedule depends on the block
    # alone; K3 runs it on another warp), so each costs a third of the
    # round warp's level of three compressions, at one instruction every
    # second clock.  K4's block loop, its schedule included, is shown beside.
    round_alu = level_alu / 3
    chain["leaf_hash_stream"] = (longest + 1) * round_alu * 2 / (clock_mhz * 1e6) * 1e3
    print(f"leaf_hash_stream chain bound, the stream flush's longest leaf: ({longest} + 1) compressions x"
          f" {round_alu:.1f} ALU-pipe instructions of rounds (K3's round warp {level_alu} / 3) x 2 clocks at"
          f" {clock_mhz:.0f} MHz = {chain['leaf_hash_stream']:.5f} ms; kernel {ms['leaf_hash_stream']:.4f} ms,"
          f" {chain['leaf_hash_stream'] / ms['leaf_hash_stream']:.3f} of it; K4's block loop"
          f" {alu(sass['leaf_hash_stream']['loop'])} ALU-pipe instructions a compression with its schedule; one"
          f" 65-compression leaf alone through the shipped loop {t_lone:.4f} ms; {smi}")
    for name in probes:
        tiles = 256
        ops[name] = alu(sass[name]["loop"]) * pp.PROBE_PASSES * tiles * pp.TILE
        work[name] = dict(bytes=tiles * (pp.PROBE_CHAINS + 1) * pp.TILE * 4)
    bound = {}
    for name in [*replaces, "leaf_hash_exact 2^18", "leaf_hash_wire"]:
        t_issue, t_bytes = ops[name] / alu_rate * 1e3, work[name]["bytes"] / 3.35e12 * 1e3
        t_ops = max(t_issue, chain.get(name, 0.0))
        bound[name] = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        binds = "bytes" if t_bytes > t_ops else "chain" if t_ops > t_issue else "issue"
        print(f"{name:17s} bound {bound[name][0]:.5f} ms by {bound[name][1]}, the {binds} binding (issue {t_issue:.5f}"
              f" ms: {ops[name]:.4g} ALU-pipe instructions at {alu_rate:.4g}/s; chain"
              f" {'%.5f ms' % chain[name] if name in chain else 'none'}; bytes {t_bytes:.5f} ms:"
              f" {work[name]['bytes']} bytes at 3.35 TB/s); kernel {ms[name]:.4f} ms,"
              f" {bound[name][0] / ms[name]:.3f} of the bound")
    print(f"per-bucket launches (one per bucket, as before): leaf_hash_exact {per_bucket_ms['leaf_hash_exact']:.4f} ms,"
          f" leaf_hash_stream {per_bucket_ms['leaf_hash_stream']:.4f} ms a flush; one 64-block leaf {t_lone:.4f} ms;"
          f" 1024-digest tail {t1024:.4f} ms; SM clock max {clock_mhz:.0f} MHz, {sms} SMs")
    kernels = [
        {"name": name, "route": "cuda", "source": f"vk_merkle_roots_tpu_torch/csrc/{src}", "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name], "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bound[name][0], "bound_by": bound[name][1], "library_ms": None,
         "chain_bound_ms": chain.get(name)}
        for name, (src, rep) in replaces.items()
    ]
    print(f"smoke wall time {time.perf_counter() - t_start:.1f} s, the kernels' build included")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
