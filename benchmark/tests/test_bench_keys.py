"""The key layer (reference/keys.py): rows made on the card (keygen.cu)
against keygen.cpp's, the same arithmetic built for the host, the route
without CUDA, the guard on the card's rows, and key files written a chunk at
a time in np.save's bytes."""

import ctypes
import os
import subprocess

import numpy as np
import pytest

from reference import curves, keys, native

LABELS = [(curves.BN254, "bn256"), (curves.GRUMPKIN, "grumpkin")]


def np_save_bytes(tmp_path, rows) -> bytes:
    path = tmp_path / "whole.npy"
    np.save(path, rows)
    return path.read_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("curve,label", LABELS)
def test_card_rows_are_keygen_cpps(curve, label):
    """Every row of 2^16 at four starts up to a 2^26-point key."""
    fn = keys.card()
    if fn is None:
        pytest.skip("needs nvcc and a CUDA device")
    stream = keys._stream(label.encode(), 1 << 26)
    for start in (0, (1 << 23) - (1 << 15), 1 << 25, (1 << 26) - (1 << 16)):
        part = stream[32 * start: 32 * (start + (1 << 16))]
        assert np.array_equal(keys._map(fn, curve, part), keys._map(None, curve, part)), start


@pytest.mark.parametrize("curve,label", LABELS)
def test_the_card_arithmetic_on_the_host(curve, label, tmp_path):
    """keygen.cu built as host C++ (its mira_keygen_host) makes keygen.cpp's
    rows."""
    so = str(tmp_path / "libkeygen_host.so")
    subprocess.run(["g++", "-x", "c++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    os.path.join(native.HERE, "keygen.cu"), "-o", so], check=True)
    host = keys._bind(ctypes.CDLL(so).mira_keygen_host, None)
    stream = keys._stream(label.encode(), 70000)
    for start in (0, 65000):
        part = stream[32 * start: 32 * (start + 1000)]
        assert np.array_equal(keys._map(lambda *a: host(*a) or 0, curve, part),
                              keys._map(None, curve, part))


class FakeLib:
    def __init__(self, devices):
        self.mira_keygen_cuda_devices = lambda: devices


@pytest.mark.parametrize("lib", [None, FakeLib(0)], ids=["no nvcc", "no device"])
def test_without_cuda_the_route_is_keygen_cpp(lib, monkeypatch, tmp_path):
    monkeypatch.setattr(keys, "cuda_library", lambda name: lib)
    assert keys.card() is None
    used, real = [], keys._map
    monkeypatch.setattr(keys, "_map", lambda fn, *a: used.append(fn) or real(fn, *a))
    keys.ensure_key(curves.GRUMPKIN, "grumpkin", 5, str(tmp_path / "5-svdw.npy"))
    assert used == [None]


@pytest.mark.parametrize("altered", [None, 0, 97, 255])
def test_the_guard_holds_card_rows_against_keygen_cpp(altered, monkeypatch, tmp_path):
    """A maker standing in for the card that alters one row is refused,
    its file taken away; one that alters none passes."""
    real = keys._map

    def card_map(fn, curve, stream):
        rows = real(None, curve, stream)
        if fn == "card" and altered is not None:
            rows[altered, 1, 3] ^= 1
        return rows

    monkeypatch.setattr(keys, "card", lambda: "card")
    monkeypatch.setattr(keys, "_map", card_map)
    path = str(tmp_path / "8-svdw.npy")
    if altered is None:
        keys.ensure_key(curves.BN254, "bn256", 8, path, seed=2**31 + 5)
        assert np.array_equal(np.load(path), real(None, curves.BN254,
                                                  keys._stream(b"bn256", 256)))
        return
    with pytest.raises(keys.KeyMismatch, match=f"the first at row {altered}"):
        keys.ensure_key(curves.BN254, "bn256", 8, path, seed=2**31 + 5)
    assert os.listdir(tmp_path) == []


def test_the_guard_samples_the_new_range():
    """4,096 strata of the rows past the head, each row of a short range,
    the first and the last row always."""
    seen = []

    def read(idx):
        seen.append(idx)
        return np.zeros((len(idx), 2, 16), dtype=np.uint32)

    stream = np.zeros(32 << 20, dtype=np.uint8)
    for start, n in ((1 << 19, 1 << 20), (100, 1100)):
        with pytest.raises(keys.KeyMismatch):
            keys.guard(curves.GRUMPKIN, stream, start, n, read, seed=7)
    wide, short = seen
    assert wide[0] == 1 << 19 and wide[-1] == (1 << 20) - 1 and len(wide) >= 4096
    assert set((wide - (1 << 19)) * 4096 // (1 << 19)) == set(range(4096))
    assert list(short) == list(range(100, 1100))


@pytest.mark.parametrize("chunk", [50, 1 << 22])
def test_streamed_files_are_np_saves(chunk, monkeypatch, tmp_path):
    """Made whole, grown from a smaller key and cut from a larger one, a
    chunk of `chunk` rows at a time: np.save's bytes of the whole array."""
    monkeypatch.setattr(keys, "CHUNK", chunk)
    whole = keys.make_rows(curves.GRUMPKIN, b"grumpkin", 1 << 9)
    ck = tmp_path / "ck"
    keys.ensure_key(curves.GRUMPKIN, "grumpkin", 6, str(ck / "6-svdw.npy"))
    keys.ensure_key(curves.GRUMPKIN, "grumpkin", 9, str(ck / "9-svdw.npy"))  # grown from 6
    keys.ensure_key(curves.GRUMPKIN, "grumpkin", 7, str(ck / "7-svdw.npy"))  # cut from 9
    for k in (6, 9, 7):
        assert (ck / f"{k}-svdw.npy").read_bytes() == np_save_bytes(tmp_path, whole[: 1 << k])
    assert sorted(os.listdir(ck)) == ["6-svdw.npy", "7-svdw.npy", "9-svdw.npy"]
