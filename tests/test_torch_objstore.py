"""The port's object-store tier, ``repro_torch.runtime.objstore``: the
object-store contract and ``ObjectBackedStore`` cases of tests/test_net.py
held against the port, torch tensors through the tier (the entries decode
through the storage codec, so a tensor comes back as a tensor), and the
specs whose backends come with a later slice of the port raising
``NotImplementedError`` rather than ``ModuleNotFoundError``."""

import numpy as np
import pytest
import torch

from repro_torch.app import TABLE1_SPACE, run_dataset_study, run_study, synthetic_tile
from repro_torch.app.pipeline import run_adaptive_study
from repro_torch.runtime import (
    InMemoryObjectStore,
    LocalFSObjectStore,
    ObjectBackedStore,
    make_backend,
    mount_store,
)
from repro_torch.runtime.storage import stable_key

# ---------------------------------------------------------------------------
# ObjectStore contract — both implementations
# ---------------------------------------------------------------------------


@pytest.fixture(params=["localfs", "memory"])
def objstore(request, tmp_path):
    if request.param == "localfs":
        return LocalFSObjectStore(str(tmp_path / "root"))
    return InMemoryObjectStore()


class TestObjectStoreContract:
    def test_put_get_head_delete(self, objstore):
        assert objstore.get("a/b") is None
        assert objstore.head("a/b") is None
        etag = objstore.put("a/b", b"hello")
        assert objstore.get("a/b") == b"hello"
        meta = objstore.head("a/b")
        assert meta.size == 5 and meta.etag == etag
        assert objstore.delete("a/b") is True
        assert objstore.delete("a/b") is False
        assert objstore.get("a/b") is None

    def test_put_replaces_whole_object(self, objstore):
        objstore.put("k", b"v1")
        e2 = objstore.put("k", b"v2-longer")
        assert objstore.get("k") == b"v2-longer"
        assert objstore.head("k").etag == e2

    def test_put_if_absent_first_writer_wins(self, objstore):
        created, etag1 = objstore.put_if_absent("k", b"first")
        assert created is True
        created, etag2 = objstore.put_if_absent("k", b"second")
        assert created is False
        assert etag2 == etag1  # the survivor's etag, not the loser's
        assert objstore.get("k") == b"first"

    def test_put_if_absent_after_delete_creates(self, objstore):
        objstore.put_if_absent("k", b"v")
        objstore.delete("k")
        created, _ = objstore.put_if_absent("k", b"v2")
        assert created is True
        assert objstore.get("k") == b"v2"

    def test_list_is_sorted_prefix_scan(self, objstore):
        for k in ("entries/b", "entries/a", "keys/a", "solo"):
            objstore.put(k, b"x")
        assert objstore.list("entries/") == ["entries/a", "entries/b"]
        assert objstore.list() == ["entries/a", "entries/b", "keys/a", "solo"]

    def test_illegal_keys_rejected(self, objstore):
        for bad in ("", "/abs", "a/../b"):
            with pytest.raises(ValueError):
                objstore.put(bad, b"x")


def test_localfs_tmp_siblings_are_not_objects(tmp_path):
    store = LocalFSObjectStore(str(tmp_path))
    store.put("entries/x", b"data")
    # a crashed writer's tmp sibling must not appear as an object
    (tmp_path / "entries" / ".x.crashed").write_bytes(b"partial")
    assert store.list() == ["entries/x"]
    assert store.get("entries/x") == b"data"


# ---------------------------------------------------------------------------
# ObjectBackedStore: the entry protocol over objects
# ---------------------------------------------------------------------------


class TestObjectBackedStore:
    def test_bit_exact_round_trip_across_mounts(self, tmp_path):
        spec = f"obj:{tmp_path / 'root'}"
        s1 = mount_store(spec, 1 << 20, writer_id="w1")
        assert isinstance(s1, ObjectBackedStore)
        arr = np.arange(16, dtype=np.int64).reshape(4, 4)
        s1.put("arr", arr)
        s1.put("scalars", {"n": 2, "s": "x", "f": 0.5})
        s1.persist_all()
        # an INDEPENDENT mount over the same root (no shared state)
        s2 = mount_store(spec, 1 << 20, writer_id="w2")
        np.testing.assert_array_equal(np.asarray(s2.get("arr")), arr)
        d = s2.get("scalars")
        assert d == {"n": 2, "s": "x", "f": 0.5}
        assert type(d["n"]) is int and type(d["s"]) is str
        assert s2.committed_keys() == {"arr", "scalars"}

    def test_conditional_write_dedup_across_writers(self, tmp_path):
        spec = f"obj:{tmp_path / 'root'}"
        s1 = mount_store(spec, 1 << 20, writer_id="w1")
        s1.put("x", np.ones(8, np.float32))
        s1.persist("x")
        s2 = mount_store(spec, 1 << 20, writer_id="w2")
        s2.put("x", np.ones(8, np.float32))
        s2.persist("x")
        assert s2.dedup_writes == 1  # lost the conditional create, no lock
        assert s1.dedup_writes == 0
        # re-persist through the same instance is a no-op, not a dedup
        s2.persist("x")
        assert s2.dedup_writes == 1

    def test_quarantine_on_corrupt_then_self_heal(self):
        fake = InMemoryObjectStore()
        s1 = ObjectBackedStore(1 << 20, fake, writer_id="w1")
        s1.put("x", np.ones(8, np.float32))
        s1.persist("x")
        sha = stable_key("x")
        fake.corrupt(f"entries/{sha}")
        s2 = ObjectBackedStore(1 << 20, fake, writer_id="w2")
        assert s2.get("x") is None  # footer check refused the bytes
        assert s2.corrupt == 1
        # evidence preserved, entry + commit record removed
        assert fake.list("quarantine/") != []
        assert fake.head(f"entries/{sha}") is None
        assert s2.committed_keys() == set()
        # the next writer self-heals
        s2.put("x", np.ones(8, np.float32))
        s2.persist("x")
        np.testing.assert_array_equal(
            np.asarray(ObjectBackedStore(1 << 20, fake).get("x")),
            np.ones(8, np.float32),
        )
        assert s2.committed_keys() == {"x"}

    def test_crash_window_entry_without_record_heals_on_recommit(self, tmp_path):
        """A writer killed between the entry put and the key-record put
        leaves a servable entry missing from committed_keys(); any peer
        re-committing the key restores the record."""
        spec = f"obj:{tmp_path / 'root'}"
        s1 = mount_store(spec, 1 << 20, writer_id="w1")
        s1.put("x", np.ones(4, np.float32))
        s1.persist("x")
        sha = stable_key("x")
        s1.objstore.delete(f"keys/{sha}")  # simulate the torn commit
        s2 = mount_store(spec, 1 << 20, writer_id="w2")
        assert s2.committed_keys() == set()
        assert s2.get("x") is not None  # the entry itself still serves
        s2.put("x", np.ones(4, np.float32))
        s2.persist("x")  # dedup-loses the entry, re-commits the record
        assert s2.dedup_writes == 1
        assert s2.committed_keys() == {"x"}

    def test_transient_put_failure_surfaces_then_recovers(self):
        fake = InMemoryObjectStore()
        s = ObjectBackedStore(1 << 20, fake)
        s.put("x", np.ones(4, np.float32))
        fake.fail_puts_once = True
        with pytest.raises(OSError):
            s.persist("x")
        s.persist("x")  # the retry lands
        assert s.committed_keys() == {"x"}

    def test_manifest_records_shape(self, tmp_path):
        s = mount_store(f"obj:{tmp_path / 'root'}", 1 << 20)
        s.put("k", np.zeros(4, np.float32))
        s.persist("k")
        records = s.manifest_records()
        assert set(records) == {"k"}
        assert records["k"]["sha"] == stable_key("k")
        assert records["k"]["len"] > 0

    def test_mount_store_spec_round_trip(self, tmp_path):
        spec = f"obj:{tmp_path / 'root'}"
        s = mount_store(spec, 1 << 20)
        assert s.disk_dir == spec  # what StudyState.save records
        again = mount_store(s.disk_dir, 1 << 20)
        assert isinstance(again, ObjectBackedStore)
        plain = mount_store(str(tmp_path / "plain"), 1 << 20)
        assert plain.disk_dir == str(tmp_path / "plain")
        with pytest.raises(ValueError):
            mount_store("obj:", 1 << 20)


# ---------------------------------------------------------------------------
# Torch tensors through the object tier
# ---------------------------------------------------------------------------


def _tensor(dtype):
    g = torch.Generator().manual_seed(7)
    if dtype == torch.bool:
        return torch.rand(5, 6, generator=g) > 0.5
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, (5, 6), generator=g, dtype=torch.int32)
    return torch.randn(5, 6, generator=g).to(dtype)


def _bitwise_equal(got, want):
    assert isinstance(got, torch.Tensor), type(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.device.type == want.device.type
    if want.dtype.is_floating_point:
        iview = {2: torch.int16, 4: torch.int32}[want.element_size()]
        assert torch.equal(got.view(iview), want.view(iview))
    else:
        assert torch.equal(got, want)


DTYPES = [torch.float32, torch.int32, torch.bool, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("medium", ["localfs", "memory"])
def test_tensor_round_trip_across_mounts(tmp_path, dtype, medium):
    """A tensor, bare and inside a task-state dict, written by one mount
    and read by an independent one: the same dtype, shape and bits, as a
    tensor (the reference tier would give back an ndarray)."""
    if medium == "localfs":
        spec = f"obj:{tmp_path / 'root'}"
        writer, reader = (mount_store(spec, 1 << 20, writer_id=w) for w in ("w1", "w2"))
    else:
        fake = InMemoryObjectStore()
        writer, reader = (ObjectBackedStore(1 << 20, fake, writer_id=w) for w in ("w1", "w2"))
    t = _tensor(dtype)
    writer.put("bare", t)
    writer.put("state", {"mask": t, "gray": _tensor(torch.float32)})
    assert writer.persist_all() == 2
    _bitwise_equal(reader.get("bare"), t)
    got = reader.get("state")
    assert set(got) == {"mask", "gray"}
    _bitwise_equal(got["mask"], t)
    _bitwise_equal(got["gray"], _tensor(torch.float32))
    assert reader.disk_hits == 2


# ---------------------------------------------------------------------------
# Specs whose backends come with the multi-process slice
# ---------------------------------------------------------------------------


def test_mount_store_obj_is_the_ports_tier(tmp_path):
    store = mount_store(f"obj:{tmp_path / 'root'}", 1 << 20)
    assert type(store).__module__ == "repro_torch.runtime.objstore"


@pytest.mark.parametrize("spec", ["socket", "socket[127.0.0.1:0]"])
def test_make_backend_socket_names_its_slice(spec):
    with pytest.raises(NotImplementedError, match="slice 3"):
        make_backend(spec)


@pytest.mark.parametrize("entry", ["run_study", "run_dataset_study", "run_adaptive_study"])
@pytest.mark.parametrize("backend", ["process", "process[none]", "socket"])
def test_study_entry_points_refuse_unported_backends(entry, backend):
    tile = synthetic_tile(8, 8, seed=0)
    call = {
        "run_study": lambda: run_study(tile, [TABLE1_SPACE.default()], backend=backend,
                                       device="cpu"),
        "run_dataset_study": lambda: run_dataset_study([tile], [TABLE1_SPACE.default()],
                                                       backend=backend, device="cpu"),
        "run_adaptive_study": lambda: run_adaptive_study([tile], backend=backend,
                                                         device="cpu"),
    }[entry]
    with pytest.raises(NotImplementedError, match="slice 3"):
        call()
