"""The checkpoints' npz writer and reader (``repro_torch.checkpoint.npz``)
against numpy's own: ``np.load`` reads what ``write_npz`` writes and
``read_npz`` reads what ``np.savez`` (and ``np.savez_compressed``)
writes, every dtype, shape and byte equal; a flipped byte fails the
CRC."""
import zipfile

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.checkpoint.npz import read_npz, write_npz  # noqa: E402


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "__spec__": np.asarray('{"kind": "dict", "name": "ü"}'),
        "params/embed": rng.integers(0, 1 << 15, (9, 4)).astype(
            np.int16).view("V2"),
        "params/w": rng.standard_normal((3, 5)).astype(np.float32),
        "opt/step": np.asarray(7, np.int32),
        "flags": np.array([True, False, True]),
        "empty": np.zeros((0, 4), np.int64),
        "fortran": np.asfortranarray(rng.standard_normal((4, 3))),
        "strided": rng.standard_normal((6, 6))[::2, 1::2],
        "big_endian": rng.standard_normal(17).astype(">f4"),
        "ünïcode": np.arange(5, dtype=np.uint8),
        "i8": rng.integers(-128, 127, 33).astype(np.int8),
    }


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype.kind == "V":
        got, want = got.view(np.uint8), want.view(np.uint8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reader", ["np.load", "read_npz"])
def test_write_npz_reads_back(tmp_path, reader):
    path = str(tmp_path / "a.npz")
    arrays = _arrays()
    write_npz(path, arrays)
    if reader == "np.load":
        with np.load(path, allow_pickle=False) as z:
            got = {k: z[k] for k in z.files}
    else:
        got = read_npz(path)
    assert list(got) == list(arrays)
    for k, v in arrays.items():
        _same(got[k], v)


@pytest.mark.parametrize("writer", [np.savez, np.savez_compressed],
                         ids=["savez", "savez_compressed"])
def test_read_npz_reads_numpy_files(tmp_path, writer):
    path = str(tmp_path / "a.npz")
    arrays = _arrays()
    writer(path, **arrays)
    got = read_npz(path)
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        _same(got[k], v)


def test_a_flipped_byte_fails_the_crc(tmp_path):
    path = str(tmp_path / "a.npz")
    write_npz(path, {"w": np.arange(1000, dtype=np.float64)})
    raw = bytearray(open(path, "rb").read())
    raw[raw.index(b"w.npy") + 400] ^= 1
    open(path, "wb").write(raw)
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        read_npz(path)
    with np.load(path) as z, pytest.raises(zipfile.BadZipFile):
        z["w"]


def test_object_arrays_are_refused(tmp_path):
    with pytest.raises(ValueError, match="object"):
        write_npz(str(tmp_path / "a.npz"),
                  {"o": np.array([{}, 1], dtype=object)})
    assert not (tmp_path / "a.npz").exists()
