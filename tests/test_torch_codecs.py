"""The port's result codecs carry torch tensors: the npz spill codec of
``runtime.storage`` and the shared-memory codec of ``runtime.transport``
give back a tensor of the same dtype, shape, values and device type, bare
or inside a dict; ndarrays and pickled values keep their bit-exact round
trip."""

import os

import numpy as np
import pytest
import torch

from repro_torch.runtime.storage import HierarchicalStore, _deserialise, _serialise
from repro_torch.runtime.transport import shm_decode, shm_encode


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(4, 6, generator=g).to(torch.bfloat16),
        "int32": torch.randint(-1000, 1000, (7,), generator=g, dtype=torch.int32),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 3),
    }


def _npz(value):
    return _deserialise(_serialise(value))


_SHM_COUNT = [0]


def _shm(value):
    _SHM_COUNT[0] += 1
    desc = shm_encode(value, f"rtc_{os.getpid()}_{_SHM_COUNT[0]}", max_bytes=1 << 20)
    assert desc is not None
    return shm_decode(desc)


def _same_tensor(got, want):
    assert isinstance(got, torch.Tensor), type(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.device.type == want.device.type
    # bitwise: compare the integer views (NaN-safe, -0.0-safe)
    if want.dtype.is_floating_point:
        iview = {2: torch.int16, 4: torch.int32, 8: torch.int64}[want.element_size()]
        assert torch.equal(got.cpu().view(iview), want.cpu().view(iview))
    else:
        assert torch.equal(got.cpu(), want.cpu())


CODECS = {"npz": _npz, "shm": _shm}


# a payload of no bytes never takes shared memory (shm_encode returns None)
@pytest.mark.parametrize("codec,name", [(c, n) for c in sorted(CODECS) for n in sorted(_tensors())
                                        if (c, n) != ("shm", "empty")])
def test_bare_tensor_round_trip(codec, name):
    t = _tensors()[name]
    _same_tensor(CODECS[codec](t), t)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_tensors_in_a_dict_round_trip(codec):
    value = {**_tensors(), "arr": np.arange(6, dtype=np.int64).reshape(2, 3)}
    got = CODECS[codec](value)
    assert set(got) == set(value)
    for k, v in value.items():
        if isinstance(v, torch.Tensor):
            _same_tensor(got[k], v)
        else:
            assert isinstance(got[k], np.ndarray) and got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)


def test_shm_nested_tensors_round_trip():
    t = _tensors()
    value = {"cache": {"state": t["f32"], "tm": t["bf16"]}, "len": 16, "ids": [t["int32"]]}
    got = _shm(value)
    assert got["len"] == 16
    _same_tensor(got["cache"]["state"], t["f32"])
    _same_tensor(got["cache"]["tm"], t["bf16"])
    _same_tensor(got["ids"][0], t["int32"])


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_ndarrays_stay_bit_exact(codec):
    a = np.array([1.5, -0.0, np.nan, np.inf], dtype=np.float32)
    got = CODECS[codec](a)
    assert isinstance(got, np.ndarray) and got.dtype == a.dtype
    assert got.tobytes() == a.tobytes()
    d = {"x": a, "n": np.array(3, dtype=np.int64)}
    got = CODECS[codec](d)
    assert got["x"].tobytes() == a.tobytes() and got["n"].shape == () and int(got["n"]) == 3


def test_npz_pickled_values_stay_bit_exact():
    value = {0: 2**70 + 1, "t": (1, "a", None), "f": 0.1}
    assert _npz(value) == value
    assert _npz([1, 2**65]) == [1, 2**65]


def test_spill_store_round_trips_tensors(tmp_path):
    """Through the on-disk tier of the spill store, as a study resumed in a
    new process reads it."""
    t = _tensors()
    value = {"state": t["f32"], "tm": t["bf16"]}
    store = HierarchicalStore(ram_bytes=1 << 20, disk_dir=str(tmp_path))
    store.put("k", value)
    assert store.persist_all() == 1
    got = HierarchicalStore(ram_bytes=1 << 20, disk_dir=str(tmp_path)).get("k")
    _same_tensor(got["state"], t["f32"])
    _same_tensor(got["tm"], t["bf16"])


@pytest.mark.gpu
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_cuda_tensors_come_back_on_the_card(codec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    value = {k: v.cuda() for k, v in _tensors().items() if v.numel()}
    got = CODECS[codec](value)
    for k, v in value.items():
        assert got[k].is_cuda
        _same_tensor(got[k], v)
    _same_tensor(CODECS[codec](value["bf16"]), value["bf16"])
