"""The PyTorch port's hot-rows cache of a sharded table against the JAX
package: the row gather / in-place row scatter (paddle_tpu_torch/ops/
kernels/embed_cache.py), one family or several at once, against the
Pallas kernels in interpret mode, one family at a time
(paddle_tpu/ops/pallas/embed_cache.py), the shard routing and row codecs
(paddle_tpu_torch/distributed/sharded_table.py) against
paddle_tpu/distributed/sharded_table.py, and ``HotRowsCache``
(paddle_tpu_torch/ops/embed_cache.py) against the JAX cache on the
schedules of tests/test_sharded_table.py, with one kernel call for all of
its families per install and per write-back.

Tolerances: none. The primitives copy rows, the codecs are elementwise
and the cache is bookkeeping, so every comparison is exact. The
primitives are held only on slots >= 0: on a negative slot the JAX
package's own tiers disagree (ROADMAP.md, section C), and the cache never
issues one.

The CUDA kernels run only on the card: the ``gpu`` tests hold them
against their plain versions there and skip elsewhere
(``pytest --noconftest -m gpu tests/test_torch_embed_cache.py``)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import sharded_table as tst
from paddle_tpu_torch.ops import embed_cache as tec
from paddle_tpu_torch.ops.kernels import embed_cache as tek


@pytest.fixture(scope="module")
def pk():
    """The JAX package's Pallas cache kernels."""
    import importlib
    pytest.importorskip("jax")
    return importlib.import_module("paddle_tpu.ops.pallas.embed_cache")


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    return torch.device("cuda")


def _cache(r=12, w=17, seed=1):
    return np.random.RandomState(seed).randn(r, w).astype(np.float32)


# -- the primitives ------------------------------------------------------------

@pytest.mark.parametrize("slots", [[0, 11, 3, 3, 7],
                                   [11, 12, 13, 40, 0, 5, 6, 1, 2, 9, 10],
                                   list(range(8)), [11]],
                         ids=["dup", "past-R", "eight", "last"])
def test_plain_gather_equals_the_pallas_kernel(pk, slots):
    """Slot R - 1, slots >= R (clamped onto R - 1), K off a multiple of
    8, duplicates: bit-equal to the interpret-mode TPU kernel."""
    import jax.numpy as jnp
    cache = _cache()
    want = np.asarray(pk.gather_rows(jnp.asarray(cache),
                                     jnp.asarray(slots, jnp.int32),
                                     interpret=True))
    got = tek.gather_rows(torch.from_numpy(cache),
                          torch.tensor(slots, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("slots", [[2, 5, 12], [11, 0, 13, 4, 12],
                                   [3, 1, 4, 0, 5, 9, 2, 6, 10, 7, 8]],
                         ids=["drop-R", "drop-R+1", "eleven"])
def test_plain_scatter_equals_the_pallas_kernel_in_place(pk, slots):
    """Slot R - 1, slots R and R + 1 dropped, K off a multiple of 8: the
    written and the untouched rows bit-equal to the interpret-mode TPU
    kernel, and the returned tensor is the cache itself."""
    import jax.numpy as jnp
    cache = _cache()
    rows = np.random.RandomState(2).randn(len(slots), 17).astype(np.float32)
    want = np.asarray(pk.scatter_rows(jnp.asarray(cache),
                                      jnp.asarray(slots, jnp.int32),
                                      jnp.asarray(rows), interpret=True))
    tc = torch.from_numpy(cache.copy())
    ptr = tc.data_ptr()
    out = tek.scatter_rows(tc, torch.tensor(slots, dtype=torch.int32),
                           torch.from_numpy(rows))
    assert out is tc and out.data_ptr() == ptr
    np.testing.assert_array_equal(out.numpy(), want)
    kept = [s for s in slots if s < 12]
    untouched = [i for i in range(12) if i not in kept]
    np.testing.assert_array_equal(out.numpy()[untouched], cache[untouched])


FAMILY_SLOTS = {"past-R": [11, 12, 13, 40, 0, 5, 6, 1, 2, 9, 10],
                "eight": list(range(8)), "last": [11]}


@pytest.mark.parametrize("n_families", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(FAMILY_SLOTS))
def test_plain_families_gather_equals_the_pallas_kernel(pk, case,
                                                        n_families):
    """Every family's rows of ``gather_rows_families`` bit-equal to the
    interpret-mode TPU kernel on that family alone: slots R - 1, slots >= R
    (clamped onto R - 1), K off a multiple of 8."""
    import jax.numpy as jnp
    slots = FAMILY_SLOTS[case]
    caches = [_cache(seed=10 + f) for f in range(n_families)]
    got = tek.gather_rows_families([torch.from_numpy(c) for c in caches],
                                   torch.tensor(slots, dtype=torch.int32))
    assert tuple(got.shape) == (n_families, len(slots), 17)
    for f, cache in enumerate(caches):
        want = np.asarray(pk.gather_rows(jnp.asarray(cache),
                                         jnp.asarray(slots, jnp.int32),
                                         interpret=True))
        np.testing.assert_array_equal(got[f].numpy(), want)


@pytest.mark.parametrize("n_families", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(FAMILY_SLOTS))
def test_plain_families_scatter_equals_the_pallas_kernel_in_place(
        pk, case, n_families):
    """Every family after ``scatter_rows_families`` bit-equal to the
    interpret-mode TPU kernel's scatter of that family's rows (slots >= R
    dropped), written in place: the same tensors, the same storage."""
    import jax.numpy as jnp
    slots = FAMILY_SLOTS[case]
    caches = [_cache(seed=20 + f) for f in range(n_families)]
    rows = np.random.RandomState(3).randn(n_families, len(slots),
                                          17).astype(np.float32)
    tcs = [torch.from_numpy(c.copy()) for c in caches]
    ptrs = [t.data_ptr() for t in tcs]
    out = tek.scatter_rows_families(tcs, torch.tensor(slots,
                                                      dtype=torch.int32),
                                    torch.from_numpy(rows))
    assert out is tcs and [t.data_ptr() for t in tcs] == ptrs
    for f, cache in enumerate(caches):
        want = np.asarray(pk.scatter_rows(jnp.asarray(cache),
                                          jnp.asarray(slots, jnp.int32),
                                          jnp.asarray(rows[f]),
                                          interpret=True))
        np.testing.assert_array_equal(tcs[f].numpy(), want)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    cache = torch.from_numpy(_cache())
    slots = torch.tensor([1, 12, -1], dtype=torch.int32)
    before = dict(tek.LAUNCHES)
    got = tek.gather_rows(cache, slots)
    assert torch.equal(got, cache[[1, 11, 0]])   # -1 reads row 0
    tek.scatter_rows(cache, slots, torch.zeros(3, 17))
    assert torch.equal(cache[1], torch.zeros(17))
    assert torch.equal(cache[0], torch.from_numpy(_cache())[0])  # -1 dropped
    assert tek.LAUNCHES == before


def test_wrappers_reject_what_they_do_not_take():
    cache = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="int32"):
        tek.gather_rows(cache, torch.tensor([0, 1]))
    with pytest.raises(ValueError, match=r"\[R, W\]"):
        tek.gather_rows(torch.zeros(4), torch.tensor([0], dtype=torch.int32))
    with pytest.raises(ValueError, match="rows must be"):
        tek.scatter_rows(cache, torch.tensor([0], dtype=torch.int32),
                         torch.zeros(2, 3))
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tek.gather_rows(meta, torch.zeros(1, dtype=torch.int32,
                                          device="meta"))


def test_families_wrappers_reject_what_they_do_not_take():
    """No family or more than four, caches of two shapes or dtypes, rows
    that are not [F, K, W]."""
    slots = torch.tensor([0, 1], dtype=torch.int32)
    cache = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="1 to 4 caches"):
        tek.gather_rows_families([], slots)
    with pytest.raises(ValueError, match="1 to 4 caches"):
        tek.gather_rows_families([cache] * 5, slots)
    for other in (torch.zeros(4, 2), torch.zeros(4, 3, dtype=torch.int32)):
        with pytest.raises(ValueError, match="caches differ"):
            tek.gather_rows_families([cache, other], slots)
    with pytest.raises(ValueError, match=r"rows must be \[2, 2, 3\]"):
        tek.scatter_rows_families([cache, cache.clone()], slots,
                                  torch.zeros(2, 3))


# -- routing and codecs --------------------------------------------------------

def test_shardspec_bounds_and_routing_equal_jax():
    """The cases of tests/test_sharded_table.py:36-84 on both specs."""
    from paddle_tpu.distributed import sharded_table as jst
    for height, n in ((10, 3), (10, 1), (8, 2), (64, 2), (100000, 2)):
        a, b = jst.ShardSpec(height, n), tst.ShardSpec(height, n)
        assert a.bounds == b.bounds
        rows = np.random.RandomState(height).randint(0, height, 37)
        rows = np.concatenate([rows, [lo for lo, _ in a.bounds],
                               [height - 1]])
        np.testing.assert_array_equal(a.owner_of(rows), b.owner_of(rows))
        ra, rb = a.route(rows), b.route(rows)
        assert sorted(ra) == sorted(rb)
        for s in ra:
            for x, y in zip(ra[s], rb[s]):
                np.testing.assert_array_equal(x, y)
    spec = tst.ShardSpec(10, 3)
    assert list(spec.owner_of([3, 4, 6, 7, 9])) == [0, 1, 1, 2, 2]
    for bad in ([8], [-1]):
        with pytest.raises(IndexError):
            tst.ShardSpec(8, 2).owner_of(bad)
    with pytest.raises(ValueError):
        tst.ShardSpec(2, 3)


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_codecs_equal_jax_bit_for_bit(codec):
    """Payloads (bf16 as its bits) and decoded rows bit-equal to JAX's,
    with an all-zero row, ties of the bf16 rounding and a row of large
    values; the same payload bytes."""
    from paddle_tpu.distributed import sharded_table as jst
    rng = np.random.RandomState(0)
    v = rng.randn(7, 9).astype(np.float32) * 3.0
    v[2] = 0.0
    v[3] = np.frombuffer(np.arange(0x3F808000, 0x3F808000 + 9 * 0x10000,
                                   0x10000, dtype=np.uint32).tobytes(),
                         np.float32)                 # bf16 ties
    v[4] *= 1e30
    a, b = jst.encode_rows(v, codec), tst.encode_rows(v, codec)
    assert a[0] == b[0] and len(a) == len(b)
    for x, y in zip(a[1:], b[1:]):
        x = np.asarray(x)
        np.testing.assert_array_equal(
            x.view(np.uint16) if codec == "bf16" else x, y)
    np.testing.assert_array_equal(jst.decode_rows(a).view(np.uint32),
                                  tst.decode_rows(b).view(np.uint32))
    assert jst.payload_nbytes(a) == tst.payload_nbytes(b)
    with pytest.raises(ValueError):
        tst.encode_rows(v, "fp4")


def test_pull_zero_fills_unknown_families_and_push_overwrites():
    """tests/test_sharded_table.py:150-185 on the in-process fleet."""
    client = tst.in_process_fleet(10, 3)
    seed = np.arange(40, dtype=np.float32).reshape(10, 4)
    client.seed_from_value("emb", seed)
    got = client.pull_rows("emb", [9, 0, 4, 7],
                           families=[("param", 4), ("moment1", 4)])
    np.testing.assert_array_equal(got["param"], seed[[9, 0, 4, 7]])
    np.testing.assert_array_equal(got["moment1"], 0.0)
    newv = -np.ones((3, 4), np.float32)
    assert client.push_rows("emb", [0, 4, 7],
                            {"param": newv, "moment1": newv * 2},
                            push_id="p1") == 3
    back = client.pull_rows("emb", [0, 4, 7],
                            families=[("param", 4), ("moment1", 4)])
    np.testing.assert_array_equal(back["param"], newv)
    np.testing.assert_array_equal(back["moment1"], newv * 2)
    np.testing.assert_array_equal(client.shards[1].rows("emb")[0], newv[1])
    assert client.push_rows("emb", [0, 4, 7], {"param": newv * 9},
                            push_id="p1") == 0
    assert sum(s.pushes_deduped for s in client.shards) == 3
    np.testing.assert_array_equal(
        client.pull_rows("emb", [0], families=[("param", 4)])["param"],
        newv[:1])


def test_a_loaded_shard_serves_its_rows_and_zero_fills_the_rest():
    """``load`` installs a shard's row block; a pull reads it back encoded
    and zero-fills a family never loaded; a block of another height is
    refused."""
    shard = tst.TableShardServer(0)
    block = np.arange(12, dtype=np.float32).reshape(3, 4)
    shard.load("emb", block)
    got = shard._pull_rows("emb", np.asarray([2, 0]),
                           [("param", 4), ("moment2", 4)], "none")
    np.testing.assert_array_equal(tst.decode_rows(got["param"]),
                                  block[[2, 0]])
    np.testing.assert_array_equal(tst.decode_rows(got["moment2"]), 0.0)
    with pytest.raises(ValueError, match="rows"):
        shard.load("emb", np.zeros((4, 4)), family="moment1")
    with pytest.raises(IndexError):
        shard._pull_rows("emb", np.asarray([3]), [("param", 4)], "none")


def test_bytes_are_counted_per_direction_and_shard():
    """tests/test_sharded_table.py:208-229: the seed pushes 4 rows of fp32
    to each of 2 shards, a pull of rows 0 and 7 reads one from each."""
    client = tst.in_process_fleet(8, 2)
    client.seed_from_value("emb", np.ones((8, 4), np.float32))
    client.pull_rows("emb", [0, 7], families=[("param", 4)])
    assert client.bytes == {("push", 0): 64, ("push", 1): 64,
                            ("pull", 0): 16, ("pull", 1): 16}


# -- the cache -----------------------------------------------------------------

SCHEDULE = ([0, 1, 2], [0, 1, 3, 7], [4], [0, 1, 5, 6])


def _jax_cache(client, capacity, padding_idx, width=4):
    import jax.numpy as jnp
    from paddle_tpu.core.scope import Scope
    from paddle_tpu.ops import embed_cache as jec
    scope = Scope()
    scope.set_var("tbl", jnp.zeros((capacity + 1, width), jnp.float32))
    return jec, jec.HotRowsCache("tbl", 16, capacity, client, scope,
                                 families={"param": ("tbl", width)},
                                 padding_idx=padding_idx)


def _port_cache(client, capacity, padding_idx=-1, width=4):
    return tec.HotRowsCache(
        "tbl", 16, capacity, client,
        {"param": torch.zeros(capacity + 1, width)}, padding_idx=padding_idx)


def test_cache_replays_the_known_schedule_as_jax_does():
    """tests/test_sharded_table.py:249-297 at capacity 4, padding_idx 7,
    on the port's cache and on the JAX cache, both over in-process
    shards: the same slots every call; 2 hits, 5 misses, 1 eviction and a
    full cache after the first three batches; the padding id on the pad
    slot; the pinned batch kept; the over-capacity batch refused."""
    seed = np.arange(64, dtype=np.float32).reshape(16, 4)
    jclient, pclient = tst.in_process_fleet(16, 2), tst.in_process_fleet(16, 2)
    for c in (jclient, pclient):
        c.seed_from_value("tbl", seed)
    jec, jcache = _jax_cache(jclient, 4, 7)
    cache = _port_cache(pclient, 4, 7)
    h0 = jec.CACHE_HITS.labels(param="tbl").value
    m0 = jec.CACHE_MISSES.labels(param="tbl").value
    e0 = jec.CACHE_EVICTIONS.labels(param="tbl").value
    got = []
    for i, batch in enumerate(SCHEDULE):
        want = jcache.translate(np.asarray(batch), train=False)
        got.append(cache.translate(np.asarray(batch), train=False))
        np.testing.assert_array_equal(got[-1], want)
        if i == 2:
            assert (cache.hits, cache.misses, cache.evictions) == (2, 5, 1)
            assert (jec.CACHE_HITS.labels(param="tbl").value - h0,
                    jec.CACHE_MISSES.labels(param="tbl").value - m0,
                    jec.CACHE_EVICTIONS.labels(param="tbl").value - e0) \
                == (2, 5, 1)
            assert cache.occupancy == 1.0 and cache.resident == 4
    assert got[1][3] == cache.pad_slot
    assert cache._slot_lut[2] == -1
    np.testing.assert_array_equal(
        cache._device_get_rows(np.asarray(got[0][:2]))["param"],
        seed[[0, 1]])
    assert cache._slot_lut[0] >= 0 and cache._slot_lut[1] >= 0
    np.testing.assert_array_equal(
        cache._device_get_rows(np.asarray(got[3]))["param"],
        seed[[0, 1, 5, 6]])
    assert cache.lookups == 11 and cache.hit_lookups == 4
    with pytest.raises(ValueError, match="cache capacity"):
        cache.translate(np.asarray([0, 1, 2, 3, 4]), train=False)


def test_cache_writes_back_on_eviction_and_flush():
    """tests/test_sharded_table.py:300-321 on the port's cache."""
    client = tst.in_process_fleet(16, 2)
    client.seed_from_value("tbl", np.zeros((16, 4), np.float32))
    cache = _port_cache(client, 2)
    s = cache.translate(np.asarray([3]), train=True)
    cache._device_set_rows(np.asarray(s),
                           {"param": 7.0 * np.ones((1, 4), np.float32)})
    cache.translate(np.asarray([8, 9]), train=True)      # evicts row 3
    got = client.pull_rows("tbl", [3], families=[("param", 4)])
    np.testing.assert_array_equal(got["param"], 7.0)
    assert (cache.installs, cache.writebacks) == (2, 1)
    assert cache.flush() == 2 and cache.flush() == 0
    assert cache.writebacks == 2
    assert cache.drop_all() == 0 and cache.resident == 0


def test_cache_makes_one_families_call_per_install_and_write_back(
        monkeypatch):
    """Over Adam's three families (param, moment1, moment2) every install
    is one ``scatter_rows_families`` call and every write-back (the
    flush's included) one ``gather_rows_families`` call, both with the
    three tensors in sorted family order; the single-family wrappers are
    never called; warmup makes one of each per bucket."""
    v, w, cap = 16, 5, 4
    param = torch.nn.Parameter(torch.randn(v, w))
    opt = topt.Adam([param], learning_rate=0.1, lazy_mode=True)
    client = tst.in_process_fleet(v, 2)
    client.seed_from_value("tbl", param.detach().numpy())
    calls = []

    def counted(name):
        fn = getattr(tek, name)

        def call(caches, *args):
            calls.append((name, [c.data_ptr() for c in caches],
                          args[0].shape[0]))
            return fn(caches, *args)
        return call

    def never(*args):
        raise AssertionError("a single-family wrapper was called")
    for name in ("gather_rows_families", "scatter_rows_families"):
        monkeypatch.setattr(tek, name, counted(name))
    for name in ("gather_rows", "scatter_rows"):
        monkeypatch.setattr(tek, name, never)
    cache = tec.enable_sharded_table(param, opt, client, cap)
    order = [cache.families[f].data_ptr()
             for f in ("moment1", "moment2", "param")]
    assert [(n, k) for n, _, k in calls] == [
        ("scatter_rows_families", 8), ("gather_rows_families", 8)]
    calls.clear()
    for batch in SCHEDULE:
        cache.translate(np.asarray(batch), train=True)
    cache.flush()
    assert cache.installs == 4 and cache.writebacks == 4
    assert [n for n, _, _ in calls].count("scatter_rows_families") == \
        cache.installs
    assert [n for n, _, _ in calls].count("gather_rows_families") == \
        cache.writebacks
    assert all(ptrs == order for _, ptrs, _ in calls)


def test_cache_refuses_families_its_kernels_cannot_take():
    """The families share one width and number at most four: the kernels
    move a row of every family per slot from one [F, K, W] buffer."""
    client = tst.in_process_fleet(16, 2)
    fams = {"param": torch.zeros(5, 4), "moment1": torch.zeros(5, 3)}
    with pytest.raises(ValueError, match="differ in width"):
        tec.HotRowsCache("tbl", 16, 4, client, fams)
    fams = {"param": torch.zeros(5, 4),
            **{f"m{i}": torch.zeros(5, 4) for i in range(4)}}
    with pytest.raises(ValueError, match="at most 4 families"):
        tec.HotRowsCache("tbl", 16, 4, client, fams)


def test_enable_sharded_table_aliases_the_parameter_and_adam_state():
    """The Parameter object stays, its storage becomes the cache's param
    tensor; Adam's moments are the cache's moment tensors, and a lazy
    step updates all three in place; any other optimizer raises."""
    v, w, cap = 16, 5, 6
    param = torch.nn.Parameter(torch.randn(v, w))
    opt = topt.Adam([param], learning_rate=0.1, lazy_mode=True)
    client = tst.in_process_fleet(v, 2)
    client.seed_from_value("tbl", param.detach().numpy())
    cache = tec.enable_sharded_table(param, opt, client, cap)
    fams = cache.families
    assert param.shape == (cap + 1, w)
    assert param.data_ptr() == fams["param"].data_ptr()
    st = opt.state[param]
    ptrs = [param.data_ptr()] + [st[m].data_ptr() for m in ("moment1",
                                                          "moment2")]
    assert ptrs[1:] == [fams[m].data_ptr() for m in ("moment1", "moment2")]
    assert st["beta1_pow"] == np.float32(0.9)
    slots = torch.from_numpy(cache.translate(np.asarray([[3, 9], [3, 4]])))
    before = [t.clone() for t in (param.detach(), st["moment1"])]
    torch.nn.functional.embedding(slots, param, sparse=True).sum().backward()
    opt.step()
    assert [param.data_ptr(), st["moment1"].data_ptr(),
            st["moment2"].data_ptr()] == ptrs
    touched = sorted(set(slots.reshape(-1).tolist()))
    for now, was in zip((param.detach(), st["moment1"]), before):
        assert not bool((now[touched] == was[touched]).all(dim=1).any())
        rest = [i for i in range(cap + 1) if i not in touched]
        assert torch.equal(now[rest], was[rest])
    other = torch.nn.Parameter(torch.randn(v, w))
    with pytest.raises(ValueError, match="no row-aligned state"):
        tec.enable_sharded_table(other, topt.Adagrad([other]), client, cap)


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("width,dtype", [(17, torch.float32),
                                         (16, torch.float32),
                                         (18, torch.float32),
                                         (7, torch.uint8)],
                         ids=["4-byte", "16-byte", "8-byte", "1-byte"])
def test_cuda_kernels_match_plain_versions(cuda_device, width, dtype):
    """Both kernels bit-equal to their plain versions at every word width
    of the copy, at K 5 (slots R - 1, R, R + 1) and at a bucket of 8192
    distinct slots; the scatter leaves every other row unchanged, writes
    through the cache's own storage, one launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    r = 32769
    for k in (5, 8192):
        cache = (torch.rand(r, width, generator=gen, device=cuda_device)
                 * 100).to(dtype)
        # distinct slots below R - 1, then R - 1, R and R + 1 once each
        slots = torch.randperm(r - 1, generator=gen,
                               device=cuda_device)[:k].to(torch.int32)
        slots[:3] = torch.tensor([r - 1, r, r + 1])
        rows = (torch.rand(k, width, generator=gen, device=cuda_device)
                * 100).to(dtype)
        orig = cache.clone()
        n0 = dict(tek.LAUNCHES)
        got = tek.gather_rows(cache, slots)
        ptr = cache.data_ptr()
        out = tek.scatter_rows(cache, slots, rows)
        torch.cuda.synchronize()
        assert {n: tek.LAUNCHES[n] - n0[n] for n in n0} == \
            {"gather_rows": 1, "scatter_rows": 1}
        assert torch.equal(got, tek.gather_rows_ref(orig, slots))
        assert out is cache and cache.data_ptr() == ptr
        assert torch.equal(cache, tek.scatter_rows_ref(orig, slots, rows))


@pytest.mark.gpu
@pytest.mark.parametrize("n_families", [1, 2, 3])
@pytest.mark.parametrize("width,dtype", [(17, torch.float32),
                                         (16, torch.float32),
                                         (18, torch.float32),
                                         (7, torch.uint8)],
                         ids=["4-byte", "16-byte", "8-byte", "1-byte"])
def test_cuda_families_kernels_match_plain_versions(cuda_device, width,
                                                    dtype, n_families):
    """Both families kernels bit-equal to their plain versions at every
    word width, at K 5 (slots R - 1, R, R + 1) and at a bucket of 8192
    distinct slots: every family written through its own storage, every
    other row unchanged, one launch a call whatever F is."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    r = 32769
    for k in (5, 8192):
        caches = [(torch.rand(r, width, generator=gen, device=cuda_device)
                   * 100).to(dtype) for _ in range(n_families)]
        slots = torch.randperm(r - 1, generator=gen,
                               device=cuda_device)[:k].to(torch.int32)
        slots[:3] = torch.tensor([r - 1, r, r + 1])
        rows = (torch.rand(n_families, k, width, generator=gen,
                           device=cuda_device) * 100).to(dtype)
        orig = [c.clone() for c in caches]
        ptrs = [c.data_ptr() for c in caches]
        n0 = dict(tek.LAUNCHES)
        got = tek.gather_rows_families(caches, slots)
        out = tek.scatter_rows_families(caches, slots, rows)
        torch.cuda.synchronize()
        assert {n: tek.LAUNCHES[n] - n0[n] for n in n0} == \
            {"gather_rows": 1, "scatter_rows": 1}
        assert torch.equal(got, tek.gather_rows_families_ref(orig, slots))
        assert out is caches and [c.data_ptr() for c in caches] == ptrs
        want = tek.scatter_rows_families_ref([o.clone() for o in orig],
                                             slots, rows)
        others = torch.ones(r, dtype=torch.bool, device=cuda_device)
        others[slots[(slots >= 0) & (slots < r)].long()] = False
        for c, w, o in zip(caches, want, orig):
            assert torch.equal(c, w)
            assert torch.equal(c[others], o[others])


@pytest.mark.gpu
def test_cuda_gather_matches_its_plain_version_before_the_scatter(
        cuda_device):
    """The gather of the cache (the families kernel at F 1) bit-equal to
    its plain version at deepfm's 68-byte rows and at a bucket padded with
    the pad slot."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    cache = torch.randn(32769, 17, generator=gen, device=cuda_device)
    slots = torch.full((8192,), 32768, dtype=torch.int32, device=cuda_device)
    slots[:5000] = torch.randperm(32768, generator=gen,
                                  device=cuda_device)[:5000].to(torch.int32)
    got = tek.gather_rows(cache, slots)
    torch.cuda.synchronize()
    assert torch.equal(got, tek.gather_rows_ref(cache, slots))
