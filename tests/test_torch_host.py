"""The port's own host modules against the JAX package's, and the rule that
the port reaches nothing of the JAX package.

The port keeps copies of the JAX-free host code (constants, utils, oracle,
config, the native host library, ingest, packing, the CPU engine, the CLI
main loop, rndm and verify).  Each is held here byte for byte against the
JAX package's module on inputs made from numpy seeds."""

import ast
import io
import pathlib
import re

import numpy as np
import pytest

from vk_merkle_roots_tpu import cli as jax_cli
from vk_merkle_roots_tpu import config as jax_config
from vk_merkle_roots_tpu import ingest as jax_ingest
from vk_merkle_roots_tpu import oracle as jax_oracle
from vk_merkle_roots_tpu import packing as jax_packing
from vk_merkle_roots_tpu.models.cpu import CpuSha256D as JaxCpu
from vk_merkle_roots_tpu.native import lib as jax_native
from vk_merkle_roots_tpu.tools import rndm as jax_rndm
from vk_merkle_roots_tpu.utils import bitmath as jax_bitmath
from vk_merkle_roots_tpu_torch import cli as port_cli
from vk_merkle_roots_tpu_torch import config as port_config
from vk_merkle_roots_tpu_torch import ingest as port_ingest
from vk_merkle_roots_tpu_torch import oracle as port_oracle
from vk_merkle_roots_tpu_torch import packing as port_packing
from vk_merkle_roots_tpu_torch.models.cpu import CpuSha256D as PortCpu
from vk_merkle_roots_tpu_torch.native import lib as port_native
from vk_merkle_roots_tpu_torch.tools import rndm as port_rndm
from vk_merkle_roots_tpu_torch.tools import verify as port_verify
from vk_merkle_roots_tpu_torch.utils import bitmath as port_bitmath

REPO = pathlib.Path(__file__).resolve().parent.parent
_JAX_NAME = re.compile(r"^vk_merkle_roots_tpu(\.|$)")


def _port_sources():
    files = sorted((REPO / "vk_merkle_roots_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    return [f for f in files if "_build" not in f.parts]


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                out.add(id(first.value))
    return out


def _jax_package_uses(path: pathlib.Path) -> list[str]:
    """Every import, ``importlib`` load, ``-m`` argument or native path of
    the JAX package in one source file."""
    tree = ast.parse(path.read_text(), str(path))
    docs = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _JAX_NAME.match(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _JAX_NAME.match(node.module or ""):
            found.append(node.module)
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            arg = node.args[0].value
            if name in ("import_module", "__import__") and isinstance(arg, str) and _JAX_NAME.match(arg):
                found.append(f"{name}({arg})")
        elif isinstance(node, (ast.List, ast.Tuple)):
            vals = [e.value if isinstance(e, ast.Constant) else None for e in node.elts]
            found += [f"-m {b}" for a, b in zip(vals, vals[1:]) if a == "-m" and isinstance(b, str)
                      and _JAX_NAME.match(b)]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            if "vk_merkle_roots_tpu/native" in node.value:
                found.append(node.value)
    return found


def test_port_sources_reach_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) >= 30 and REPO / "chip_smoke.py" in files
    bad = {str(f.relative_to(REPO)): uses for f in files if (uses := _jax_package_uses(f))}
    assert not bad, bad


def test_static_check_finds_each_kind_of_use(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text(
        '"""Docstring naming vk_merkle_roots_tpu/native/lib.py is fine."""\n'
        "import vk_merkle_roots_tpu.oracle\n"
        "from vk_merkle_roots_tpu import packing\n"
        "from vk_merkle_roots_tpu_torch import packing as ours\n"
        "import importlib\n"
        "importlib.import_module('vk_merkle_roots_tpu.cli')\n"
        "cmd = ['python', '-m', 'vk_merkle_roots_tpu.tools.verify', '-m', 'vk_merkle_roots_tpu_torch.cli']\n"
        "lib = 'vk_merkle_roots_tpu/native/libvkmr_native.so'\n"
    )
    assert _jax_package_uses(src) == [
        "vk_merkle_roots_tpu.oracle", "vk_merkle_roots_tpu", "import_module(vk_merkle_roots_tpu.cli)",
        "-m vk_merkle_roots_tpu.tools.verify", "vk_merkle_roots_tpu/native/libvkmr_native.so",
    ]


def _spans(leaves):
    lengths = np.array([len(x) for x in leaves], np.int64)
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
    return np.frombuffer(b"".join(leaves), np.uint8), offsets, lengths


def _leaves(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes() for n in lengths]


PACK_CASES = {
    "uniform": (lambda r: r.integers(56, 119, 3000), None),  # the one-bucket fast path
    "exact": (lambda r: r.integers(1, 503, 2500), None),  # 1..8-block buckets, reordered
    "stream": (lambda r: np.concatenate([r.integers(1, 300, 400), r.integers(520, 3000, 60)]), None),
    "host": (lambda r: np.concatenate([r.integers(1, 120, 300), r.integers(520, 1500, 40)]), 14),
}


def _assert_packs_equal(case, same_path: bool):
    """The port's packer against the JAX package's on one case.  ``order``
    and ``inverse_order`` are compared by value; whether they are one array
    depends on the packer's path (the native one-bucket fast path aliases
    them, the NumPy path does not), so it is compared only when both
    packages took the same path."""
    lengths_fn, max_blocks = PACK_CASES[case]
    leaves = _leaves(len(case), lengths_fn(np.random.default_rng(len(case))))
    ours = port_packing.pack_spans(*_spans(leaves), max_device_blocks=max_blocks)
    ref = jax_packing.pack_spans(*_spans(leaves), max_device_blocks=max_blocks)
    assert (ours.count, ours.total_bytes) == (ref.count, ref.total_bytes)
    if same_path:
        assert (ours.order is ours.inverse_order) == (ref.order is ref.inverse_order)
    assert np.array_equal(ours.order, ref.order) and np.array_equal(ours.inverse_order, ref.inverse_order)
    assert len(ours.buckets) == len(ref.buckets)
    for a, b in zip(ours.buckets, ref.buckets):
        assert (a.nblocks, a.count) == (b.nblocks, b.count)
        assert a.words.dtype == b.words.dtype and np.array_equal(a.words, b.words)
        assert (a.counts is None) == (b.counts is None)
        assert a.counts is None or np.array_equal(a.counts, b.counts)
    assert (ours.host_spans is None) == (ref.host_spans is None)
    if ref.host_spans is not None:
        assert all(np.array_equal(x, y) for x, y in zip(ours.host_spans, ref.host_spans))
    leaf = leaves[3]
    assert np.array_equal(port_packing.reference_padded_words(leaf), jax_packing.reference_padded_words(leaf))


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_spans_equals_jax(case):
    # The JAX package's loader falls back to NumPy for the whole process when
    # it finds no usable library (for one, while another process rebuilds it).
    _assert_packs_equal(case, (jax_native._load() is None) == (port_native._load() is None))


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_spans_numpy_fallback_equals_jax(case, monkeypatch):
    """Both packages without their native library: the port's NumPy packer
    against the JAX package's."""
    monkeypatch.setattr(port_native, "_load", lambda: None)
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    assert not port_native.native_available() and not jax_native.native_available()
    _assert_packs_equal(case, True)


@pytest.mark.parametrize("count", [1, 2, 3, 7, 64, 100, 257])
def test_oracle_equals_jax(count):
    leaves = _leaves(count, np.random.default_rng(count).integers(0, 90, count))
    assert port_oracle.merkle_root(leaves) == jax_oracle.merkle_root(leaves)
    for k in (0, 2, 5):
        assert port_oracle.merkle_root_sliced(leaves, k) == jax_oracle.merkle_root_sliced(leaves, k)
    digs = [port_oracle.leaf_hash(x) for x in leaves]
    h = (count - 1).bit_length() + 1
    assert port_oracle.reduce_slice(digs, h) == jax_oracle.reduce_slice(digs, h)
    for i in {0, count // 2, count - 1}:
        path = port_oracle.merkle_proof_of_digests(digs, i, height=h)
        assert path == jax_oracle.merkle_proof_of_digests(digs, i, height=h)
        assert port_oracle.verify_proof(digs[i], path) == jax_oracle.verify_proof(digs[i], path)


@pytest.fixture(scope="module")
def both_native():
    if not (port_native.native_available() and jax_native.native_available()):
        pytest.skip("a native host library did not build")
    return port_native, jax_native


@pytest.mark.parametrize("seed,count,maxlen", [(1712489279, 1024, 127), (7, 5000, 2), (99, 300, 3000)])
def test_native_rndm_equals_jax(both_native, seed, count, maxlen):
    ours, ref = both_native
    stream = ours.native_rndm_stream(seed, count, maxlen)
    assert stream == ref.native_rndm_stream(seed, count, maxlen)
    a, b = io.BytesIO(), io.BytesIO()
    assert port_rndm.generate_glibc(seed, count, maxlen, a) == jax_rndm.generate_glibc(seed, count, maxlen, b)
    assert a.getvalue() == b.getvalue() == stream


def test_rndm_python_generator_equals_jax():
    ours, ref = port_rndm.GlibcRand(1712489279), jax_rndm.GlibcRand(1712489279)
    assert [ours.rand() for _ in range(2000)] == [ref.rand() for _ in range(2000)]
    a, b = io.BytesIO(), io.BytesIO()
    port_rndm.generate_numpy(5, 3000, 200, a)
    jax_rndm.generate_numpy(5, 3000, 200, b)
    assert a.getvalue() == b.getvalue()


def test_native_hashing_reduce_and_packers_equal_jax(both_native):
    ours, ref = both_native
    rng = np.random.default_rng(31)
    leaves = _leaves(32, np.concatenate([rng.integers(1, 500, 2000), rng.integers(600, 9000, 50)]))
    data, offs, lens = _spans(leaves)
    digs = ours.native_leaf_hashes_spans(data, offs, lens)
    assert np.array_equal(digs, ref.native_leaf_hashes_spans(data, offs, lens))
    assert digs[5].tobytes() == jax_oracle.leaf_hash(leaves[5])
    assert ours.native_leaf_hashes(leaves[:50]) == ref.native_leaf_hashes(leaves[:50])
    for n, height in ((1, -1), (2050, -1), (1000, 10), (1, 3)):
        assert ours.native_merkle_root(digs[:n], height) == ref.native_merkle_root(digs[:n], height)
    small = lens <= 120
    args = (data, offs[small], lens[small], 2, 2)
    assert np.array_equal(ours.native_pack_bucket_tiles(*args), ref.native_pack_bucket_tiles(*args))
    big = lens > 600
    args = (data, offs[big], lens[big], 160, 1)
    assert np.array_equal(ours.native_pack_stream_bucket_tiles(*args), ref.native_pack_stream_bucket_tiles(*args))


@pytest.mark.parametrize("count", [1, 5, 1000])
def test_cpu_engine_equals_jax(count):
    leaves = _leaves(count + 1, np.random.default_rng(count).integers(1, 200, count))
    ours, ref = PortCpu(), JaxCpu()
    assert ours.AddSpans(*_spans(leaves)) and ref.AddSpans(*_spans(leaves))
    assert ours.Root() == ref.Root() == jax_oracle.merkle_root(leaves).hex()
    assert ours.Proof(count - 1) == ref.Proof(count - 1)
    assert ours.Reset() and ours.Root() == ""


def test_ingest_and_config_equal_jax():
    stream = b"ab\n\nxyz" * 4000 + b"tail-without-newline"
    for chunk in (7, 4096):
        ours = list(port_ingest.iter_line_spans(io.BytesIO(stream), chunk))
        ref = list(jax_ingest.iter_line_spans(io.BytesIO(stream), chunk))
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert port_config.auto_host_pending_bytes() == jax_config.auto_host_pending_bytes()
    ours, ref = port_config.EngineConfig(), jax_config.EngineConfig()
    shared = set(ours.__dataclass_fields__) & set(ref.__dataclass_fields__)
    assert set(ours.__dataclass_fields__) <= set(ref.__dataclass_fields__)
    assert {f: getattr(ours, f) for f in shared} == {f: getattr(ref, f) for f in shared}
    for k in range(12):
        assert np.array_equal(port_bitmath.bit_reverse_indices(k), jax_bitmath.bit_reverse_indices(k))


def _cli_run(module, engine, stream, **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = module.run(engine, io.BytesIO(stream), out=out, err=err, **kw)
    # The summary line ends with the wall time in ms, which differs run to run.
    return rc, re.sub(r" in [0-9.e+-]+$", " in T", out.getvalue(), flags=re.M), err.getvalue()


@pytest.mark.parametrize("kw", [{}, {"proof_index": 3}, {"proof_index": 99}, {"stats": True}])
def test_cli_run_equals_jax(kw):
    stream = b"alpha\n\nbeta\ngamma\n" + b"".join(b"%d\n" % i for i in range(40)) + b"last"
    ours = _cli_run(port_cli, PortCpu(), stream, **kw)
    ref = _cli_run(jax_cli, JaxCpu(), stream, **kw)
    assert ours == ref
    assert ours[0] == (1 if kw.get("proof_index") == 99 else 0)
    assert "CPU: computed root (of 44 item(s)" in ours[1] and ours[2].startswith("Read an empty string?")


def test_cli_run_resume_checks_equal_jax():
    """The skip of a journaled prefix and its checks: a good prefix, a
    changed one and a stream that ends inside it."""
    stream = b"".join(b"leaf-%d\n" % i for i in range(100))
    data, offs, lens = port_packing.split_lines(stream)
    import hashlib

    good = {"bytes": int(lens[:64].sum()), "sha256": hashlib.sha256(stream[: int(offs[64])]).hexdigest()}
    bad = dict(good, sha256="0" * 64)
    for check, skip, text in ((good, 64, stream), (bad, 64, stream), (good, 64, stream[:300])):
        ours = _cli_run(port_cli, PortCpu(), text, skip_leaves=skip, resume_check=check)
        ref = _cli_run(jax_cli, JaxCpu(), text, skip_leaves=skip, resume_check=check)
        assert ours == ref


def test_verify_tool_checks_a_port_proof(tmp_path):
    leaves = [b"x%d" % i for i in range(11)]
    engine = PortCpu()
    engine.AddMany(leaves)
    rec = {"leaf_index": 6, "root": engine.Root(),
           "path": [{"sibling": s.hex(), "side": d} for s, d in engine.Proof(6)]}
    assert port_verify.verify_proof_json(rec, leaves[6]) == (True, rec["root"])
    assert not port_verify.verify_proof_json(rec, leaves[5])[0]


def test_strm_equals_jax(capsysbinary):
    from vk_merkle_roots_tpu.tools import strm as jax_strm
    from vk_merkle_roots_tpu_torch.tools import strm as port_strm

    args = ["alpha", "", "beta gamma", "é"]
    assert port_strm.main(args) == 0
    ours = capsysbinary.readouterr().out
    assert jax_strm.main(args) == 0
    assert ours == capsysbinary.readouterr().out == "alpha\n\nbeta gamma\né\n".encode()


def _jax_cpu_cli(tmp_path) -> pathlib.Path:
    """The JAX package's CPU CLI, compiled from its sources into ``tmp_path``
    with its Makefile's flags (the Makefile would build into the package
    directory): with OpenMP, or without it where libgomp does not link."""
    import subprocess

    from vk_merkle_roots_tpu_torch import _build

    src = REPO / "vk_merkle_roots_tpu" / "native"
    exe = tmp_path / "vkmr-cpu-jax"
    for openmp in (True, False):
        sha_flags, util_flags = _build._host_flags(openmp)
        steps = [["g++", *sha_flags, "-c", "-o", str(tmp_path / "a.o"), str(src / "vkmr_native.cpp")],
                 ["g++", *util_flags, "-c", "-o", str(tmp_path / "b.o"), str(src / "vkmr_host_util.cpp")],
                 ["g++", *util_flags, "-o", str(exe), str(src / "vkmr_cpu_main.cpp"), str(tmp_path / "a.o"),
                  str(tmp_path / "b.o")]]
        if all(subprocess.run(cmd, capture_output=True, timeout=300).returncode == 0 for cmd in steps):
            return exe
    raise AssertionError("the JAX package's CPU CLI did not build")


def test_cpu_cli_binary_equals_jax(tmp_path):
    """The port's CPU CLI with no Python, built by ``_build.build_cpu_cli``
    against the port's library, prints what the JAX package's prints on one
    rndm stream, and on a stream with empty lines and a trailing fragment."""
    import subprocess

    from vk_merkle_roots_tpu_torch import _build

    ours = _build.build_cpu_cli()
    assert ours is not None and ours.parent == _build._BUILD
    ref = _jax_cpu_cli(tmp_path)
    streams = [port_native.native_rndm_stream(1712489279, 5000, 127), b"a\n\nbb\nccc\n\n\ndddd"]
    for stream in streams:
        got = [subprocess.run([str(exe)], input=stream, capture_output=True, timeout=120) for exe in (ours, ref)]
        assert [g.returncode for g in got] == [0, 0]
        a, b = (re.sub(rb" in [0-9.e+-]+\n$", b"", g.stdout) for g in got)
        assert a == b and a.startswith(b"CPU-native: computed root (of ")
        assert got[0].stderr == got[1].stderr
    leaves = [x for x in streams[1].split(b"\n") if x]
    assert a.endswith(b"=> " + jax_oracle.merkle_root(leaves).hex().encode())


def test_package_api_equals_jax():
    """The port's package-level API is the JAX package's, and importing it
    imports neither torch nor anything of the JAX package."""
    import subprocess
    import sys

    import vk_merkle_roots_tpu as jax_pkg
    import vk_merkle_roots_tpu_torch as port_pkg

    assert port_pkg.__all__ == jax_pkg.__all__
    leaves = _leaves(5, np.random.default_rng(5).integers(1, 80, 77))
    assert port_pkg.merkle_root(leaves) == jax_pkg.merkle_root(leaves)
    assert port_pkg.merkle_root_sliced(leaves, 4) == jax_pkg.merkle_root_sliced(leaves, 4)
    assert port_pkg.sha256d(b"abc") == jax_pkg.sha256d(b"abc")
    engine = port_pkg.CpuSha256D()
    assert isinstance(engine, port_pkg.Sha256dEngine) and engine.AddMany(leaves)
    assert engine.Root() == jax_pkg.merkle_root(leaves).hex()
    code = ("import sys, vk_merkle_roots_tpu_torch as v\n"
            "assert v.merkle_root([b'a']) and v.CpuSha256D().Name() == 'CPU'\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'vk_merkle_roots_tpu')))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stdout + r.stderr[-2000:]


def test_every_native_and_cuda_source_is_package_data():
    """Every .cu, .cuh and .cpp of the port matches a package-data glob of
    ``pyproject.toml``, so an installed port has the sources it builds."""
    import tomllib

    with open(REPO / "pyproject.toml", "rb") as fh:
        data = tomllib.load(fh)["tool"]["setuptools"]["package-data"]
    pkg = REPO / "vk_merkle_roots_tpu_torch"
    sources = [p for ext in ("*.cu", "*.cuh", "*.cpp") for p in pkg.rglob(ext) if "_build" not in p.parts]
    assert len(sources) >= 8
    missing = []
    for path in sources:
        parts = path.relative_to(REPO).parts
        covered = any(parts[:k] == tuple(name.split(".")) and len(parts) - k == glob.count("/") + 1
                      and pathlib.PurePath(*parts[k:]).match(glob)
                      for name, globs in data.items() for glob in globs for k in range(1, len(parts)))
        if not covered:
            missing.append(str(path.relative_to(REPO)))
    assert not missing, missing


# Public names of the JAX package's JAX-free modules that the port leaves out
# by design, each with the reason.
JAX_ONLY = {
    "config.enable_persistent_cache": "turns on JAX's compilation cache; the port's kernels are built once by"
                                      " _build and kept by content hash",
    "config.EngineConfig.backend": "the Pallas/XLA switch of the JAX engine; the port has one kernel per device kind",
    "config.EngineConfig.stats_sample_every": "the JAX engine's sampled device timing through sync round trips;"
                                              " the port times every flush with CUDA events",
    "utils.bitmath.pow2_env": "reads the Pallas grids' tile knobs (VKMR_*_TILES); no CUDA kernel of the port"
                              " takes its grid from the environment",
}
SURFACE_MODULES = ["oracle", "packing", "constants", "ingest", "config", "utils", "utils.bitmath", "utils.hexutil",
                   "utils.log", "utils.timing", "models.base", "models.cpu", "tools.rndm", "tools.strm",
                   "tools.verify"]


def _public_surface(module: str) -> list[str]:
    """Public names of the JAX package's ``module``, read from its source
    (importing it is not needed): top-level functions, classes, constants and
    a package's re-exports, and each class's public methods and fields, as
    ``module.name`` and ``module.Class.member``."""
    parts = module.split(".")
    path = REPO.joinpath("vk_merkle_roots_tpu", *parts)
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ClassDef):
            names.append(node.name)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names.append(f"{node.name}.{sub.name}")
                elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    names.append(f"{node.name}.{sub.target.id}")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
        elif isinstance(node, ast.ImportFrom) and node.level == 1 and path.name == "__init__.py":
            names += [a.asname or a.name for a in node.names]
    return [f"{module}.{n}" for n in names if not any(p.startswith("_") for p in n.split("."))]


def test_surface_check_reads_classes_and_reexports():
    assert "oracle.merkle_proof" in _public_surface("oracle")
    packing = _public_surface("packing")
    assert {"packing.Bucket.leaf_words", "packing.Bucket.counts", "packing.pack_spans"} <= set(packing)
    assert not any(".__" in n or "._" in n for n in packing)
    assert {"utils.largest_pow2_le", "utils.StopWatch"} <= set(_public_surface("utils"))
    assert "config.EngineConfig.backend" in _public_surface("config")


def _port_has(module: str, full: str) -> bool:
    """Whether the port's ``module`` has the JAX name ``full`` (a dataclass
    field counts as a class member)."""
    import importlib

    obj = importlib.import_module(f"vk_merkle_roots_tpu_torch.{module}")
    for part in full[len(module) + 1 :].split("."):
        fields = getattr(obj, "__dataclass_fields__", {})
        if part in fields:
            obj = fields[part]
        elif hasattr(obj, part):
            obj = getattr(obj, part)
        else:
            return False
    return True


@pytest.mark.parametrize("module", SURFACE_MODULES)
def test_port_has_the_jax_modules_public_surface(module):
    """Every public name of the JAX package's module exists in the port's
    module of the same path, a class's methods and dataclass fields
    included, unless it is listed in :data:`JAX_ONLY`."""
    missing = [n for n in _public_surface(module) if n not in JAX_ONLY and not _port_has(module, n)]
    assert not missing, missing


def test_jax_only_names_are_current():
    """Each name of :data:`JAX_ONLY` is public in the JAX package and still
    absent from the port."""
    owners = {n: m for m in SURFACE_MODULES for n in _public_surface(m)}
    assert set(JAX_ONLY) <= set(owners), set(JAX_ONLY) - set(owners)
    assert not [n for n in JAX_ONLY if _port_has(owners[n], n)]


def test_new_surface_functions_equal_jax():
    """The functions the port gained for the surface, on seeded inputs."""
    from vk_merkle_roots_tpu.utils import bitmath as jb
    from vk_merkle_roots_tpu.utils import hexutil as jh
    from vk_merkle_roots_tpu.utils import log as jl
    from vk_merkle_roots_tpu_torch.utils import hexutil as ph
    from vk_merkle_roots_tpu_torch.utils import log as pl

    rng = np.random.default_rng(77)
    for n in (1, 2, 31, 64, 100):
        leaves = _leaves(n, rng.integers(0, 200, n))
        assert [port_oracle.sha256(x) for x in leaves] == [jax_oracle.sha256(x) for x in leaves]
        for i in sorted({0, n // 3, n - 1}):
            assert port_oracle.merkle_proof(leaves, i) == jax_oracle.merkle_proof(leaves, i)
        with pytest.raises(IndexError):
            port_oracle.merkle_proof(leaves, n)
    with pytest.raises(IndexError):
        port_oracle.merkle_proof([b"a", b"b"], 2)
    leaves = _leaves(9, np.concatenate([rng.integers(0, 500, 1500), rng.integers(520, 2000, 20)]))
    ours = port_packing.pack_spans(*_spans(leaves), max_device_blocks=24)
    ref = jax_packing.pack_spans(*_spans(leaves), max_device_blocks=24)
    for a, b in zip(ours.buckets, ref.buckets):
        for i in sorted({0, a.count // 2, a.count - 1, min(a.count - 1, 1030)}):
            assert np.array_equal(a.leaf_words(i), b.leaf_words(i))
    for n in (1, 2, 3, 1000, 1 << 40):
        assert port_bitmath.largest_pow2_le(n) == jb.largest_pow2_le(n)
    digest = port_oracle.sha256d(b"abc")
    assert ph.digest_to_hex(digest) == jh.digest_to_hex(digest)
    assert np.array_equal(ph.digest_to_words(digest), jh.digest_to_words(digest))
    assert ph.words_to_digest(ph.digest_to_words(digest)) == digest
    assert pl.get_logger().name == jl.get_logger().name
