"""The port's record store (``repro_torch/serve/cache_store.py``) against
the JAX package's (``repro/serve/cache_store.py``): the JAX suite's store
cases (tests/test_cache_store.py) run through both stores, then records
saved by one store load in the other and the two stores' files are equal
byte for byte. The records are plain python and numpy values, as the
port's calibration pass stores them; the JAX suite's own cases store sweep
records, which the port does not have yet."""
import os

import numpy as np
import pytest

from repro.serve import cache_store as jax_store
from repro_torch.serve import cache_store as port_store

STORES = {"jax": jax_store, "port": port_store}


def _entries():
    """One record of each kind a store meets: nested containers of
    floats, ints, strings and bools, a numpy array, and a key that is a
    tuple."""
    rng = np.random.default_rng(0)
    return {
        "profile": {"flops_per_s": 9.76e12, "bytes_per_s": 7.62e10,
                    "samples": [("gemm", (768, 768, 768), 1.2e-4)]},
        ("eval", 3, "hbm"): {"latency": 1.5e-3, "valid": True,
                             "parts": [1, 2, 3]},
        "array": rng.standard_normal((4, 5)),
        "tail": "last record",
    }


def _assert_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", STORES)
def test_round_trip_exact(tmp_path, name):
    mod = STORES[name]
    store = mod.CacheStore(tmp_path / "c.bin")
    store.save(_entries())
    loaded = store.load()
    assert not store.last_load.cold_start
    assert not store.last_load.torn_tail
    assert store.last_load.entries == len(_entries())
    _assert_equal(_entries(), loaded)


@pytest.mark.parametrize("name", STORES)
def test_append_accumulates(tmp_path, name):
    mod = STORES[name]
    entries = _entries()
    keys = list(entries)
    store = mod.CacheStore(tmp_path / "c.bin")
    store.append({k: entries[k] for k in keys[:2]})   # file + header
    store.append({k: entries[k] for k in keys[2:]})
    assert store.append({}) == 0
    _assert_equal(entries, store.load())


@pytest.mark.parametrize("name", STORES)
def test_schema_mismatch_cold_start_with_reason(tmp_path, monkeypatch,
                                                name):
    mod = STORES[name]
    path = tmp_path / "c.bin"
    monkeypatch.setattr(mod, "SCHEMA_VERSION", 999)
    mod.CacheStore(path).save(_entries())
    monkeypatch.undo()
    store = mod.CacheStore(path)
    assert store.load() == {}
    assert store.last_load.cold_start
    assert "schema" in store.last_load.reason


@pytest.mark.parametrize("name", STORES)
def test_missing_and_foreign_files_cold_start(tmp_path, name):
    mod = STORES[name]
    store = mod.CacheStore(tmp_path / "absent.bin")
    assert store.load() == {}
    assert store.last_load.cold_start
    assert store.last_load.reason == "no store file"

    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"\x00\x01not a store" * 7)
    store = mod.CacheStore(junk)
    assert store.load() == {}
    assert store.last_load.cold_start


@pytest.mark.parametrize("name", STORES)
def test_torn_write_recovery(tmp_path, name):
    mod = STORES[name]
    entries = _entries()
    path = tmp_path / "c.bin"
    mod.CacheStore(path).save(entries)
    with open(path, "r+b") as f:      # drop the last 7 bytes: a torn tail
        f.truncate(os.path.getsize(path) - 7)
    store = mod.CacheStore(path)
    loaded = store.load()
    assert store.last_load.torn_tail
    assert not store.last_load.cold_start
    assert 0 < len(loaded) < len(entries)
    _assert_equal({k: entries[k] for k in loaded}, loaded)
    store.save(entries)               # a fresh save after recovery
    _assert_equal(entries, mod.CacheStore(path).load())


@pytest.mark.parametrize("name", STORES)
def test_torn_header_cold_start(tmp_path, name):
    mod = STORES[name]
    path = tmp_path / "c.bin"
    mod.CacheStore(path).save(_entries())
    with open(path, "r+b") as f:
        f.truncate(5)                 # inside the header record
    store = mod.CacheStore(path)
    assert store.load() == {}
    assert store.last_load.cold_start


@pytest.mark.parametrize("name", STORES)
def test_corrupt_record_checksum_drops_tail(tmp_path, name):
    mod = STORES[name]
    entries = _entries()
    path = tmp_path / "c.bin"
    mod.CacheStore(path).save(entries)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:      # flip one byte of the last record
        f.seek(size - 3)
        b = f.read(1)
        f.seek(size - 3)
        f.write(bytes([b[0] ^ 0xFF]))
    store = mod.CacheStore(path)
    loaded = store.load()
    assert store.last_load.torn_tail
    assert len(loaded) == len(entries) - 1
    _assert_equal({k: entries[k] for k in loaded}, loaded)


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_records_load_in_the_other_store(tmp_path, writer, reader):
    """Saved and appended by one store, loaded by the other."""
    entries = _entries()
    keys = list(entries)
    path = tmp_path / "c.bin"
    STORES[writer].CacheStore(path).save({k: entries[k] for k in keys[:2]})
    STORES[writer].CacheStore(path).append({k: entries[k]
                                            for k in keys[2:]})
    store = STORES[reader].CacheStore(path)
    _assert_equal(entries, store.load())
    assert not store.last_load.cold_start and not store.last_load.torn_tail


def test_files_are_equal_byte_for_byte(tmp_path):
    """The same records give the same file through either store, by
    save and by save then append; the format constants agree."""
    assert port_store.MAGIC == jax_store.MAGIC
    assert port_store.SCHEMA_VERSION == jax_store.SCHEMA_VERSION
    entries = _entries()
    keys = list(entries)
    blobs = {}
    for name, mod in STORES.items():
        mod.CacheStore(tmp_path / f"{name}.bin").save(entries)
        appended = tmp_path / f"{name}-appended.bin"
        mod.CacheStore(appended).save({k: entries[k] for k in keys[:1]})
        mod.CacheStore(appended).append({k: entries[k] for k in keys[1:]})
        blobs[name] = ((tmp_path / f"{name}.bin").read_bytes(),
                       appended.read_bytes())
    assert blobs["jax"] == blobs["port"]
    assert blobs["port"][0] == blobs["port"][1]
