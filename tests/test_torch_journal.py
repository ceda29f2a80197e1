"""The port's journal, resume, digest sidecars and Merkle proofs (the TORCH
engine and ``vkmr-torch``) against the JAX engine (TpuSha256D,
backend="xla"), the JAX CLI and the oracle: journal rows and sidecars byte
for byte, proofs path for path, resume across the two packages both ways,
the JAX package's journal and proof cases rerun on the port, and the port's
own repairs (any pack failure rolls the pipeline back; one tail readback
with keep_digests; atomic, torn-tolerant sidecars)."""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from vk_merkle_roots_tpu.config import EngineConfig as JaxEngineConfig
from vk_merkle_roots_tpu.models import tpu as jax_engine
from vk_merkle_roots_tpu.models.tpu import TpuSha256D
from vk_merkle_roots_tpu_torch import oracle
from vk_merkle_roots_tpu_torch.config import EngineConfig
from vk_merkle_roots_tpu_torch.models.cuda import CudaSha256D, load_digest_sidecars
from vk_merkle_roots_tpu_torch.packing import split_lines
from tests.test_torch_engine import _leaves, _root_of, _run

torch.set_num_threads(1)
SLICE = 64  # slice_log2 = 6 throughout


def _cfg(tmp_path=None, jax=False, **kw):
    """The port's config, or with ``jax`` the JAX engine's (backend xla)."""
    kw.setdefault("slice_log2", 6)
    kw.setdefault("batch_leaves", 40)
    if tmp_path is not None:
        kw.setdefault("journal_path", str(tmp_path / "journal.jsonl"))
    return JaxEngineConfig(backend="xla", **kw) if jax else EngineConfig(**kw)


def _port(**kw):
    return CudaSha256D(device="cpu", config=_cfg(**kw))


def _rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _roots(path):
    return [bytes.fromhex(r["root"]) for r in _rows(path)]


def _verifies(leaf, path, root_hex):
    return oracle.verify_proof(oracle.leaf_hash(leaf), path).hex() == root_hex


def _feed(engine, stream, chunk):
    """AddSpans over a newline stream in ``chunk``-line pieces: pieces
    straddle slice boundaries and carry newline framing, so the stream
    digest's coverage rule is exercised."""
    data, offs, lens = split_lines(stream)
    for lo in range(0, lens.size, chunk):
        assert engine.AddSpans(data, offs[lo : lo + chunk], lens[lo : lo + chunk])


# (batch_leaves, count, chunk): pow-2 batches give grouped slices (150 leaves
# leave a grouped tail with a partial scatter), 30/40 natural ones.
LAYOUTS = [(16, 150, 23), (16, 200, 64), (30, 200, 17), (40, 200, 200)]


@pytest.mark.parametrize("batch,count,chunk", LAYOUTS)
def test_journal_sidecars_and_proofs_equal_jax(tmp_path, batch, count, chunk):
    leaves = [x.replace(b"\n", b"_") for x in _leaves(batch + count, count, maxlen=40)]
    stream = b"".join(x + b"\n" for x in leaves)
    want = oracle.merkle_root(leaves).hex()
    engines = {}
    for kind in ("jax", "port"):
        (tmp_path / kind).mkdir()
        cfg = _cfg(tmp_path / kind, jax=kind == "jax", batch_leaves=batch, keep_digests=True)
        e = TpuSha256D(name="ref", config=cfg) if kind == "jax" else CudaSha256D(device="cpu", config=cfg)
        _feed(e, stream, chunk)
        assert e.Root() == want
        engines[kind] = (e, cfg.journal_path)
    (ref, jref), (port, jport) = engines["jax"], engines["port"]
    rows = _rows(jport)
    assert rows == _rows(jref) and len(rows) == count // SLICE
    assert all(set(r) == {"slice", "leaves", "root", "bytes", "sha256"} for r in rows)
    for i in range(len(rows)):
        a, b = np.load(f"{jport}.digests.{i}.npy"), np.load(f"{jref}.digests.{i}.npy")
        assert a.dtype == b.dtype == np.uint32 and np.array_equal(a, b)
    for i in sorted({0, 5, 63, 64, 127, 128, count - 1}):
        path = port.Proof(i)
        assert path == ref.Proof(i)
        assert _verifies(leaves[i], path, want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_proofs_after_resume_with_sidecars(tmp_path, writer):
    """Sidecars written by either engine restore the port's proofs for the
    journaled prefix after a resume; the JAX loader reads the port's too."""
    leaves = _leaves(11, 200, maxlen=40)
    cfg = _cfg(tmp_path, jax=writer == "jax", keep_digests=True)
    e = TpuSha256D(name="w", config=cfg) if writer == "jax" else CudaSha256D(device="cpu", config=cfg)
    assert e.AddMany(leaves)
    want = e.Root()
    roots = _roots(cfg.journal_path)
    digests = load_digest_sidecars(cfg.journal_path, roots, SLICE)
    assert len(digests) == 3
    assert all(np.array_equal(a, b) for a, b in
               zip(digests, jax_engine.load_digest_sidecars(cfg.journal_path, roots, SLICE)))
    e2 = _port(keep_digests=True)
    e2.PreloadSliceRoots(roots, digests=digests)
    assert e2.AddMany(leaves[192:])
    assert e2.Root() == want == oracle.merkle_root(leaves).hex()
    for i in (0, 10, 63, 64, 150, 193, 199):
        assert _verifies(leaves[i], e2.Proof(i), want)


@pytest.mark.parametrize("kept", [2, 3])
def test_resume_from_journal_prefix(tmp_path, kept):
    """A whole journal and one cut short by a crash both resume to the same
    root, on a port engine and on the JAX engine."""
    leaves = _leaves(12, 200, maxlen=40)
    cfg = _cfg(tmp_path)
    e = CudaSha256D(device="cpu", config=cfg)
    assert e.AddMany(leaves)
    want = e.Root()
    assert [r["slice"] for r in _rows(cfg.journal_path)] == [0, 1, 2]
    roots = _roots(cfg.journal_path)[:kept]
    for resumed in (_port(), TpuSha256D(name="r", config=_cfg(jax=True))):
        resumed.PreloadSliceRoots(roots)
        assert resumed.AddMany(leaves[kept * SLICE :])
        assert resumed.Root() == want


def test_preload_requires_fresh_engine():
    e = _port()
    e.AddMany(_leaves(13, 3, maxlen=10))
    with pytest.raises(RuntimeError, match="fresh engine"):
        e.PreloadSliceRoots([bytes(32)])


def test_proof_refusals(tmp_path):
    leaves = _leaves(14, 200, maxlen=40)
    plain = _port()
    plain.AddMany(leaves[:5])
    plain.Root()
    with pytest.raises(RuntimeError, match="keep_digests"):
        plain.Proof(0)

    cfg = _cfg(tmp_path)
    e = CudaSha256D(device="cpu", config=cfg)
    assert e.AddMany(leaves)
    want = e.Root()
    e2 = _port(keep_digests=True)
    e2.PreloadSliceRoots(_roots(cfg.journal_path))
    assert e2.AddMany(leaves[192:])
    with pytest.raises(RuntimeError, match="after Root"):
        e2.Proof(195)
    assert e2.Root() == want
    with pytest.raises(RuntimeError, match="resumed from a journal"):
        e2.Proof(10)
    with pytest.raises(IndexError):
        e2.Proof(200)
    assert _verifies(leaves[195], e2.Proof(195), want)


@pytest.mark.parametrize("count", [10, 64, 200])
def test_engine_proof_multi_slice(count):
    leaves = _leaves(count, count, maxlen=50)
    e = _port(batch_leaves=30, keep_digests=True)
    assert e.AddMany(leaves)
    root = e.Root()
    for i in {0, count // 2, count - 1}:
        assert _verifies(leaves[i], e.Proof(i), root)


def test_journal_records_integrity_fields(tmp_path):
    leaves = _leaves(15, 200, maxlen=40)
    cfg = _cfg(tmp_path)
    e = CudaSha256D(device="cpu", config=cfg)
    e.AddMany(leaves)
    e.Root()
    recs = _rows(cfg.journal_path)
    assert len(recs) == 3
    for i, r in enumerate(recs):
        assert r["bytes"] == sum(len(x) for x in leaves[: (i + 1) * SLICE])
        assert r["sha256"] == hashlib.sha256(b"".join(leaves[: (i + 1) * SLICE])).hexdigest()


def test_overlapping_spans_digest_covers_leaf_bytes(tmp_path):
    e = CudaSha256D(device="cpu", config=_cfg(tmp_path, batch_leaves=4))
    data = np.frombuffer(b"ABCDEFGHIJ" * 20, np.uint8)
    assert e.AddSpans(data, np.array([100, 0], np.int64), np.array([10, 10], np.int64))
    assert e._stream_sha.hexdigest() == hashlib.sha256(data[100:110].tobytes() + data[0:10].tobytes()).hexdigest()
    assert e._stream_bytes == 20


def test_grow_after_root_redoes_tail_snapshot():
    leaves = _leaves(16, 150, maxlen=40)
    e = _port(batch_leaves=16, keep_digests=True)
    assert e.AddMany(leaves[:80])
    assert e.Root() == oracle.merkle_root(leaves[:80]).hex()
    assert len(e._slice_digests) == 2
    assert e.AddMany(leaves[80:])
    root = e.Root()
    assert root == oracle.merkle_root(leaves).hex()
    assert [d.shape[0] for d in e._slice_digests] == [64, 64, 22]
    for i in (70, 100, 149):
        assert _verifies(leaves[i], e.Proof(i), root)


def _journal_with_sidecars(tmp_path, count=100):
    leaves = _leaves(17, count, maxlen=30)
    cfg = _cfg(tmp_path, keep_digests=True)
    e = CudaSha256D(device="cpu", config=cfg)
    e.AddMany(leaves)
    e.Root()
    return cfg.journal_path, _roots(cfg.journal_path)


def test_digest_sidecar_corruption_refuses(tmp_path):
    journal, roots = _journal_with_sidecars(tmp_path)
    side = f"{journal}.digests.0.npy"
    d = np.load(side)
    d[3, 0] ^= 1
    np.save(side, d)
    with pytest.raises(ValueError, match="stale or corrupted"):
        load_digest_sidecars(journal, roots, SLICE)


@pytest.mark.parametrize("damage", ["missing", "truncated", "empty", "header_only", "wrong_shape", "pickled"])
def test_digest_sidecar_missing_or_torn_counts_as_missing(tmp_path, damage):
    """A sidecar that is missing, torn by a crash or of the wrong shape
    makes the resume root-only (None), never an exception."""
    journal, roots = _journal_with_sidecars(tmp_path)
    side = f"{journal}.digests.0.npy"
    raw = open(side, "rb").read()
    if damage == "missing":
        os.unlink(side)
    elif damage == "wrong_shape":
        np.save(side, np.zeros((SLICE // 2, 8), np.uint32))
    elif damage == "pickled":
        np.save(side, np.array([None] * 8, dtype=object), allow_pickle=True)
    else:
        keep = {"truncated": len(raw) - 100, "empty": 0, "header_only": 50}[damage]
        with open(side, "wb") as fh:
            fh.write(raw[:keep])
    assert load_digest_sidecars(journal, roots, SLICE) is None


def test_sidecar_write_is_atomic(tmp_path, monkeypatch):
    """A failure while a sidecar is written propagates and leaves no file,
    whole or partial, under the sidecar's name or its temporary name."""
    real_save = np.save

    def failing_save(fh, arr, *a, **kw):
        fh.write(b"\x93NUMPY partial")
        raise OSError("fake: disk full")

    monkeypatch.setattr(np, "save", failing_save)
    cfg = _cfg(tmp_path, keep_digests=True)
    e = CudaSha256D(device="cpu", config=cfg)
    with pytest.raises(OSError, match="disk full"):
        e.AddMany(_leaves(18, 100, maxlen=30))
        e.Root()
    side = f"{cfg.journal_path}.digests.0.npy"
    assert not os.path.exists(side) and not os.path.exists(side + ".tmp")
    monkeypatch.setattr(np, "save", real_save)
    e = CudaSha256D(device="cpu", config=cfg)
    e.AddMany(_leaves(18, 100, maxlen=30))
    e.Root()
    assert np.load(side).shape == (SLICE, 8) and not os.path.exists(side + ".tmp")


@pytest.mark.parametrize("pack_ahead", [0, 2])
def test_pack_failure_rolls_the_pipeline_back(monkeypatch, pack_ahead):
    """Any exception from the pack thread, not only MemoryError, returns the
    failed job's leaves and every queued job's to the pending queue before
    it propagates; the next Root() is still the oracle root."""
    real = CudaSha256D._pack_worker
    calls = [0]

    def flaky(self, *args):
        calls[0] += 1
        if calls[0] == 3:
            raise ValueError("fake: pack failed")
        return real(self, *args)

    monkeypatch.setattr(CudaSha256D, "_pack_worker", flaky)
    leaves = _leaves(19, 300, maxlen=30)
    e = _port(batch_leaves=16, pack_ahead=pack_ahead)
    with pytest.raises(ValueError, match="pack failed"):
        e.AddMany(leaves)
    assert e._inflight_nbytes == 0 and not e._pack_jobs
    assert e._pending.count == len(leaves) - e._full_slices * SLICE - e._fill
    assert e.Root() == oracle.merkle_root(leaves).hex()


def test_host_tail_with_keep_digests_reads_back_once(monkeypatch):
    """With keep_digests, a host-reduced tail is read back once, and that
    one array is both the snapshot and the host reduce's input."""
    leaves = _leaves(20, 50, maxlen=30)
    e = _port(batch_leaves=16, keep_digests=True, host_tail_leaves=8192)
    assert e.AddMany(leaves) and e.Drain()
    reads = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(t, *a, **kw):
        reads.append(tuple(t.shape))
        return real_cpu(t, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    assert e.Root() == oracle.merkle_root(leaves).hex()
    assert reads == [(50, 8)]
    assert _verifies(leaves[33], e.Proof(33), oracle.merkle_root(leaves).hex())


@pytest.mark.parametrize("state", ["journaling", "preloaded"])
def test_slice_oom_walk_refused(tmp_path, monkeypatch, state):
    """The slice-OOM walk must not shrink the slice once journaling has
    digested a leaf or slices were adopted from a journal: ingest fails soft
    and the slice height stays."""
    def fail_empty(*shape, **kw):
        raise torch.cuda.OutOfMemoryError("fake: no memory")

    monkeypatch.setattr(CudaSha256D, "_SLICE_FLOOR_LOG2", 2)
    if state == "journaling":
        e = CudaSha256D(device="cpu", config=_cfg(tmp_path, batch_leaves=16))
    else:
        e = _port(batch_leaves=16)
        e.PreloadSliceRoots([bytes(32)])
    monkeypatch.setattr(torch, "empty", fail_empty)
    assert e.AddMany(_leaves(21, 40, maxlen=30)) is False
    assert e.config.slice_log2 == 6


# -- the CLI ------------------------------------------------------------------

CLI_LEAVES = [bytes([65 + i % 26]) * (1 + i % 40) for i in range(200)]
CLI_STREAM = b"".join(x + b"\n" for x in CLI_LEAVES)
CLI_ROOT = oracle.merkle_root(CLI_LEAVES).hex()
CLIS = {"jax": ("vk_merkle_roots_tpu.cli", "XLA"), "port": ("vk_merkle_roots_tpu_torch.cli", "TORCH")}


def _cli(who, args, stdin):
    module, engine = CLIS[who]
    return _run([engine, *args], stdin, module=module)


def _proof_of(proc):
    return json.loads(proc.stdout.decode().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def prefix_journals(tmp_path_factory):
    """A journal with its sidecars written by each CLI (``--proof``) over
    the first 96 leaves: one full slice."""
    out = {}
    for who in CLIS:
        d = tmp_path_factory.mktemp(f"prefix_{who}")
        r = _cli(who, ["--slice-log2", "6", "--journal", str(d / "j.jsonl"), "--proof", "5"],
                 b"".join(x + b"\n" for x in CLI_LEAVES[:96]))
        assert _root_of(r) == oracle.merkle_root(CLI_LEAVES[:96]).hex()
        assert os.path.exists(d / "j.jsonl.digests.0.npy")
        out[who] = d
    return out


def _copy(src, tmp_path):
    dst = tmp_path / "copy"
    shutil.copytree(src, dst)
    return str(dst / "j.jsonl")


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_cli_cross_package_resume(prefix_journals, tmp_path, writer, reader):
    journal = _copy(prefix_journals[writer], tmp_path)
    r = _cli(reader, ["--slice-log2", "6", "--journal", journal, "--proof", "10"], CLI_STREAM)
    assert "Resuming from journal: 1 slice(s), skipping 64 leaf/leaves" in r.stderr.decode()
    assert _root_of(r) == CLI_ROOT
    proof = _proof_of(r)
    assert proof["leaf_index"] == 10 and proof["root"] == CLI_ROOT
    assert _verifies(CLI_LEAVES[10], [(bytes.fromhex(p["sibling"]), p["side"]) for p in proof["path"]], CLI_ROOT)
    assert [row["slice"] for row in _rows(journal)] == [0, 1, 2]


@pytest.mark.parametrize("damage", ["corrupt", "torn", "missing"])
def test_cli_sidecar_damage(prefix_journals, tmp_path, damage):
    """A corrupt sidecar refuses the resume; a torn or missing one gives a
    root-only resume whose proof of a journaled leaf refuses loudly."""
    journal = _copy(prefix_journals["port"], tmp_path)
    side = journal + ".digests.0.npy"
    if damage == "corrupt":
        d = np.load(side)
        d[0, 0] ^= 1
        np.save(side, d)
    elif damage == "torn":
        raw = open(side, "rb").read()
        with open(side, "wb") as fh:
            fh.write(raw[: len(raw) // 2])
    else:
        os.unlink(side)
    r = _cli("port", ["--slice-log2", "6", "--journal", journal, "--proof", "10"], CLI_STREAM)
    assert r.returncode == 1
    if damage == "corrupt":
        assert b"stale or corrupted" in r.stderr and b"=>" not in r.stdout
    else:
        assert f"=> {CLI_ROOT}" in r.stdout.decode()
        assert b"proof error" in r.stderr and b"resumed from a journal" in r.stderr


@pytest.fixture(scope="module")
def full_journal(tmp_path_factory):
    """The port CLI's journal over all 200 leaves: three full slices."""
    d = tmp_path_factory.mktemp("full")
    r = _cli("port", ["--slice-log2", "6", "--journal", str(d / "j.jsonl")], CLI_STREAM)
    assert _root_of(r) == CLI_ROOT
    assert len(_rows(d / "j.jsonl")) == 3
    return d


def test_cli_journal_roundtrip(full_journal, tmp_path):
    journal = _copy(full_journal, tmp_path)
    b = _cli("port", ["--slice-log2", "6", "--journal", journal], CLI_STREAM)
    assert "Resuming from journal: 3 slice(s)" in b.stderr.decode() and _root_of(b) == CLI_ROOT

    # A journal written at another height is resumed at its own.
    c = _cli("port", ["--slice-log2", "8", "--journal", journal], CLI_STREAM)
    assert "slice_log2=6; resuming with that" in c.stderr.decode() and _root_of(c) == CLI_ROOT

    # A journal covering the whole stream still prints the root and totals.
    full = b"".join(bytes([65 + i % 26]) * 5 + b"\n" for i in range(128))
    j2 = str(tmp_path / "full.jsonl")
    root_d = _root_of(_cli("port", ["--slice-log2", "6", "--journal", j2], full))
    e = _cli("port", ["--slice-log2", "6", "--journal", j2], full)
    assert "Resuming from journal: 2 slice(s)" in e.stderr.decode()
    assert f"(of 128 item(s), 640 byte(s)) => {root_d}" in e.stdout.decode()

    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"slice": 0, "leaves": 96, "root": "' + "00" * 32 + '"}\n')
    f = _cli("port", ["--slice-log2", "6", "--journal", str(bad)], full)
    assert f.returncode == 1 and b"not a power of two" in f.stderr


@pytest.mark.parametrize("change", ["flipped_byte", "same_length", "truncated"])
def test_cli_resume_refuses_another_stream(full_journal, tmp_path, change):
    journal = _copy(full_journal, tmp_path)
    bad = bytearray(CLI_STREAM)
    if change == "flipped_byte":
        bad[10] ^= 1
    elif change == "same_length":
        bad[3] = 90
    else:
        bad = b"\n".join(CLI_STREAM.split(b"\n")[:100]) + b"\n"
    r = _cli("port", ["--slice-log2", "6", "--journal", journal], bytes(bad))
    assert r.returncode == 1
    assert b"journal/stream mismatch" in r.stderr and b"=>" not in r.stdout
