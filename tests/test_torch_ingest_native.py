"""``iter_line_spans`` with the native line scan (``vkmr_split_lines``)
against the NumPy split it replaces (``packing.split_lines``) and the JAX
package's ``iter_line_spans``, chunk for chunk and array for array; its
fallback to NumPy without the library; and the rule that every yielded
batch keeps its bytes while later reads arrive."""

import io
from collections import Counter

import numpy as np
import pytest

from vk_merkle_roots_tpu import ingest as jax_ingest
from vk_merkle_roots_tpu_torch import ingest
from vk_merkle_roots_tpu_torch.native import lib
from vk_merkle_roots_tpu_torch.packing import split_lines

CHUNKS = (1, 7, 4096, 1 << 16)
STREAMS = {
    "empty": lambda chunk: b"",
    "only_newlines": lambda chunk: b"\n" * 300,
    "empty_lines_inside": lambda chunk: b"ab\n\n\ncd\n\nef\n",
    "trailing_fragment": lambda chunk: b"one\ntwo\nthree-without-newline",
    "boundary_on_newline": lambda chunk: (b"x" * (chunk - 1) + b"\n") * 5,
    "line_over_ten_chunks": lambda chunk: b"head\n" + b"y" * (10 * chunk + 3) + b"\ntail",
    "rndm127": lambda chunk: lib.native_rndm_stream(1712489279, 300, 127),
}


@pytest.fixture
def native(monkeypatch):
    """The library loaded, and a fresh count of the reads each path split."""
    if not lib.native_available():
        pytest.skip("the native host library did not build")
    counts = Counter()
    monkeypatch.setattr(ingest, "split_reads", counts)
    return counts


class ReadOnly:
    """A stream object with ``read()`` and nothing else."""

    def __init__(self, data: bytes) -> None:
        self._inner = io.BytesIO(data)

    def read(self, n: int) -> bytes:
        return self._inner.read(n)


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert a[0].dtype == np.uint8 and a[1].dtype == a[2].dtype == np.int64


def _lines(batches):
    return [bytes(d[o : o + n]) for d, offs, lens in batches for o, n in zip(offs, lens)]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", sorted(STREAMS))
def test_native_split_equals_numpy_and_jax(native, case, chunk):
    stream = STREAMS[case](chunk)
    ours = list(ingest.iter_line_spans(io.BytesIO(stream), chunk))
    _assert_same(ours, list(jax_ingest.iter_line_spans(io.BytesIO(stream), chunk)))
    _assert_same(ours, list(ingest._numpy_line_spans(io.BytesIO(stream), chunk)))
    # The batches' lines are split_lines' over the whole stream.
    assert _lines(ours) == (_lines([split_lines(stream)]) if stream else [])
    assert native["native"] == -(-len(stream) // chunk)


@pytest.mark.parametrize("chunk", (7, 4096))
def test_a_read_only_stream(native, chunk):
    stream = STREAMS["rndm127"](chunk) + STREAMS["line_over_ten_chunks"](chunk)
    ours = list(ingest.iter_line_spans(ReadOnly(stream), chunk))
    _assert_same(ours, list(jax_ingest.iter_line_spans(io.BytesIO(stream), chunk)))
    assert native["native"] > 0 and native["numpy"] == 0


@pytest.mark.parametrize("case", ["only_newlines", "trailing_fragment", "line_over_ten_chunks", "rndm127"])
def test_numpy_fallback_without_the_library(native, monkeypatch, case):
    stream = STREAMS[case](7)
    with_library = list(ingest.iter_line_spans(io.BytesIO(stream), 7))
    monkeypatch.setattr(lib, "_load", lambda: None)
    assert not lib.native_available() and lib.native_split_lines(np.zeros(1, np.uint8), 1) is None
    native.clear()
    without = list(ingest.iter_line_spans(io.BytesIO(stream), 7))
    _assert_same(without, with_library)
    _assert_same(without, list(jax_ingest.iter_line_spans(io.BytesIO(stream), 7)))
    assert native == Counter(numpy=-(-len(stream) // 7))


@pytest.mark.parametrize("chunk", (7, 4096, 1 << 16))
def test_every_batch_keeps_its_bytes_after_later_reads(native, chunk):
    stream = (STREAMS["rndm127"](chunk) + STREAMS["line_over_ten_chunks"](chunk)) * 3
    kept = list(ingest.iter_line_spans(io.BytesIO(stream), chunk))  # compared only once all reads are done
    assert len(kept) > 2
    _assert_same(kept, list(jax_ingest.iter_line_spans(io.BytesIO(stream), chunk)))
    assert len({d.__array_interface__["data"][0] for d, _, _ in kept}) == len(kept)


@pytest.mark.parametrize("expect", [None, 1, 3])
def test_the_scan_rescans_when_its_room_is_short(native, expect):
    data = np.frombuffer(b"a\n\nbc\nd\nef", np.uint8).copy()
    starts, lengths = lib.native_split_lines(data, data.size, 0, expect)
    assert starts.tolist() == [0, 2, 3, 6] and lengths.tolist() == [1, 0, 2, 1]
    # begin: the head is a line carried from an earlier read, searched no more.
    data = np.frombuffer(b"xyzw\nv\n\nu", np.uint8).copy()
    starts, lengths = lib.native_split_lines(data, data.size, 3, expect)
    assert starts.tolist() == [0, 5, 7] and lengths.tolist() == [4, 1, 0]


@pytest.mark.parametrize("args", [(np.zeros(4, np.int64), 4), (np.zeros(4, np.uint8), 5),
                                  (np.zeros(4, np.uint8), 2, 3), (np.zeros(8, np.uint8)[::2], 4)])
def test_the_scan_refuses_a_buffer_it_cannot_read(native, args):
    with pytest.raises(ValueError):
        lib.native_split_lines(*args)
