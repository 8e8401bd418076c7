"""The PyTorch port's deepfm training (paddle_tpu_torch/models/deepfm.py),
on one table and over the hot-rows cache of a 2-shard fleet
(paddle_tpu_torch/ops/embed_cache.py, distributed/sharded_table.py),
against the JAX executor on the program of tests/_dist_utils.py
``build_deepfm_small`` (4 fields, V 64, K 8, fc 400 x 3, lazy Adam 1e-2)
and the 14 feeds of tests/test_sharded_table.py:354-361, from the JAX
startup's weights (``convert.deepfm_params_from_jax``).

Oracles: the JAX executor's single-table losses; and the JAX sharded run
(``enable_sharded_table(..., use_pallas=True, pallas_interpret=True)``)
at capacity 48, whose installs and write-backs go through the two Pallas
cache kernels in interpret mode (jitted here, one compile per bucket, with
a call counter as the witness that they ran). It runs at that one
capacity only: its interpret-mode warmup and steps take ~8 s.

Tolerances: losses rtol 1e-4 (fp32 products of another order over 14
lazy-Adam steps); the fleet's rows after ``flush`` against the port's
single-table run rtol 1e-6 (the same arithmetic on the same rows, the
moments carried exactly through evictions) with atol 1e-8, one
millionth of the table's scale (uniform in +-0.01): the sparse
gradient's duplicate rows are summed in another order when their indices
are cache slots, which leaves up to ~5e-9 on elements near 0."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import sharded_table as tst
from paddle_tpu_torch.models import convert, deepfm
from paddle_tpu_torch.ops import embed_cache as tec

LOSS_RTOL = 1e-4
ROWS_RTOL = 1e-6
ROWS_ATOL = 1e-8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_fields=4, vocab_size=64, embed_dim=8, lr=1e-2)


def _feeds(steps=14, batch=16, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, 64, size=(batch, 4, 1)).astype("int64")
        lab = (ids[:, 0, 0] % 2).astype("float32")[:, None]
        out.append({"feat_ids": ids, "label": lab})
    return out


def _jax_sharded_pallas(capacity):
    """The JAX sharded run through the interpret-mode Pallas kernels:
    (losses, kernel calls)."""
    import jax
    import paddle_tpu.fluid as fluid
    from paddle_tpu.core.scope import Scope
    from paddle_tpu.ops import embed_cache as jec
    from paddle_tpu.ops.pallas import embed_cache as pk
    from _dist_utils import build_deepfm_small
    main, startup, loss = build_deepfm_small()
    scope = Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    # the JAX cache is duck-typed on its client: the port's in-process
    # fleet serves it
    client = tst.in_process_fleet(64, 2)
    client.seed_from_value("deepfm_emb",
                           np.asarray(scope.find_var("deepfm_emb")))
    calls = {"gather_rows": 0, "scatter_rows": 0}
    jitted = {n: jax.jit(getattr(pk, n), static_argnames="interpret")
              for n in calls}

    def counted(name):
        def call(*args, **kw):
            calls[name] += 1
            return jitted[name](*args, **kw)
        return call
    saved = {n: getattr(pk, n) for n in calls}
    try:
        for n in calls:
            setattr(pk, n, counted(n))
        jec.enable_sharded_table(main, scope, "deepfm_emb", client=client,
                                 capacity=capacity, use_pallas=True,
                                 pallas_interpret=True)
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0]) for f in _feeds()]
    finally:
        for n, fn in saved.items():
            setattr(pk, n, fn)
    return losses, calls


@pytest.fixture(scope="module")
def jx():
    """JAX side: the startup's weights, the single-table losses and the
    sharded run through the Pallas kernels at capacity 48."""
    pytest.importorskip("jax")
    import paddle_tpu.fluid as fluid
    from paddle_tpu.core.scope import Scope
    from _dist_utils import build_deepfm_small
    main, startup, loss = build_deepfm_small()
    scope = Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    arrays = {p.name: np.asarray(scope.find_var(p.name))
              for p in main.global_block().all_parameters()}
    base = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
            for f in _feeds()]
    pallas_losses, calls = _jax_sharded_pallas(48)
    return dict(arrays=arrays, losses=base, pallas_losses=pallas_losses,
                pallas_calls=calls)


def _train(state, capacity=None):
    """The port's deepfm 14 steps, on one table or over a cache of
    ``capacity`` rows on 2 in-process shards: (losses, model, optimizer,
    cache, client, data_ptrs at the first and the last step)."""
    model, opt, _ = deepfm.build(**CFG, device="cpu")
    model.load_state_dict(state)
    cache = client = None
    if capacity:
        client = tst.in_process_fleet(64, 2)
        client.seed_from_value("deepfm_emb", state["emb"].numpy())
        cache = tec.enable_sharded_table(model.emb, opt, client, capacity)
    losses, ptrs = [], []
    for f in _feeds():
        ids = f["feat_ids"]
        if cache is not None:
            ids = cache.translate(ids)
        opt.zero_grad(set_to_none=True)
        loss, prob = model(torch.from_numpy(ids), torch.from_numpy(f["label"]))
        loss.backward()
        opt.step()
        losses.append(loss.item())
        st = opt.state[model.emb]
        ptrs.append((model.emb.data_ptr(), st["moment1"].data_ptr(),
                     st["moment2"].data_ptr()))
    return losses, model, opt, cache, client, ptrs


def test_single_table_matches_the_jax_executor(jx):
    losses, model, *_ = _train(convert.deepfm_params_from_jax(jx["arrays"]))
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jx["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("capacity", [64, 48])
def test_cache_over_two_shards_matches_the_jax_executor(jx, capacity):
    """At capacity 64 the whole vocabulary fits; at 48 every step evicts
    and writes dirty rows back. Losses as the JAX executor's; after
    ``flush`` the fleet holds the port's single-table rows; the table and
    both moments never changed storage."""
    state = convert.deepfm_params_from_jax(jx["arrays"])
    evictions = tec.CACHE_EVICTIONS.labels(param="deepfm_emb")
    e0 = evictions.value
    losses, _, _, cache, client, ptrs = _train(state, capacity)
    np.testing.assert_allclose(losses, jx["losses"], rtol=LOSS_RTOL)
    assert ptrs[0] == ptrs[-1] == tuple(
        cache.families[f].data_ptr() for f in ("param", "moment1",
                                               "moment2"))
    single = _train(state)[1].emb.detach().numpy()
    cache.flush()
    pulled = client.pull_rows("deepfm_emb", np.arange(64),
                              families=[("param", 9)])["param"]
    np.testing.assert_allclose(pulled, single, rtol=ROWS_RTOL,
                               atol=ROWS_ATOL)
    if capacity == 48:
        assert evictions.value - e0 > 0 and cache.writebacks > 10
    else:
        assert evictions.value - e0 == 0 and cache.resident == 64


def test_jax_run_through_the_pallas_cache_kernels_agrees(jx):
    """The JAX sharded run at capacity 48 through the interpret-mode
    Pallas gather and scatter gives the single-table losses, as the port's
    cache does."""
    assert jx["pallas_calls"]["scatter_rows"] > 0
    assert jx["pallas_calls"]["gather_rows"] > 0
    np.testing.assert_allclose(jx["pallas_losses"], jx["losses"],
                               rtol=LOSS_RTOL)
    state = convert.deepfm_params_from_jax(jx["arrays"])
    np.testing.assert_allclose(_train(state, 48)[0], jx["pallas_losses"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_sigmoid_ce_matches_the_jax_op(normalize):
    """``sigmoid_cross_entropy_with_logits`` with labels at ignore_index
    (-100) among them, with and without ``normalize``, against the JAX op
    (rtol 1e-6: elementwise fp32)."""
    from op_test import run_single_op
    from paddle_tpu_torch.ops import nn_ops
    rng = np.random.RandomState(3)
    x = (rng.randn(6, 4) * 3).astype(np.float32)
    label = rng.randint(0, 2, (6, 4)).astype(np.float32)
    label[1, 2] = label[4, 0] = -100.0
    want = run_single_op("sigmoid_cross_entropy_with_logits",
                         {"X": {"x": x}, "Label": {"label": label}},
                         {"normalize": normalize})["__out_Out_0"]
    got = nn_ops.sigmoid_cross_entropy_with_logits(
        torch.from_numpy(x), torch.from_numpy(label), normalize=normalize)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert got[1, 2] == 0 and got[4, 0] == 0


@pytest.mark.parametrize("op,ins,attrs", [
    ("slice", "Input", dict(axes=[2, 0], starts=[1, -3], ends=[100, -1])),
    ("reduce_sum", "X", dict(dim=[1])),
    ("reduce_sum", "X", dict(dim=[1], keep_dim=True)),
    ("reshape", "X", dict(shape=[0, -1])),
    ("square", "X", {}),
    ("sigmoid", "X", {})], ids=["slice", "reduce_sum", "reduce_sum-keep",
                                "reshape", "square", "sigmoid"])
def test_small_ops_match_the_jax_ops(op, ins, attrs):
    """deepfm's small ops against the JAX ops: bounds clipped and counted
    from the end, reductions kept or not, a 0 in a shape (exact but the
    sum's order and the sigmoid: rtol 1e-6)."""
    from op_test import run_single_op
    from paddle_tpu_torch.ops import nn_ops
    x = np.random.RandomState(4).randn(4, 3, 5).astype(np.float32)
    want = run_single_op(op, {ins: {"x": x}}, attrs)["__out_Out_0"]
    t = torch.from_numpy(x)
    got = {"slice": lambda: nn_ops.slice(t, attrs["axes"], attrs["starts"],
                                         attrs["ends"]),
           "reduce_sum": lambda: nn_ops.reduce_sum(
               t, attrs["dim"], attrs.get("keep_dim", False)),
           "reshape": lambda: nn_ops.reshape(t, attrs["shape"]),
           "square": lambda: nn_ops.square(t),
           "sigmoid": lambda: nn_ops.sigmoid(t)}[op]()
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_params_from_jax_checks_names_and_shapes(jx):
    arrays = dict(jx["arrays"])
    state = convert.deepfm_params_from_jax(arrays)
    assert set(state) == set(deepfm.param_shapes(4, 64, 8))
    with pytest.raises(KeyError):
        convert.deepfm_params_from_jax({k: v for k, v in arrays.items()
                                        if k != "deepfm_emb"})
    arrays["deepfm_emb"] = arrays["deepfm_emb"][:, :6]    # K 5: 32 / 5 fields
    with pytest.raises(ValueError, match="shape"):
        convert.deepfm_params_from_jax(arrays)


def test_build_runs_on_cuda_unless_the_cpu_is_asked_for():
    model, opt, specs = deepfm.build(num_fields=3, vocab_size=10,
                                     embed_dim=4, device="cpu")
    assert model.emb.shape == (10, 5) and model.emb.device.type == "cpu"
    assert opt.lazy_mode and specs["feat_ids"] == ([-1, 3, 1], "int64")
    if torch.cuda.is_available():
        assert deepfm.build(num_fields=3, vocab_size=10, embed_dim=4)[0] \
            .emb.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            deepfm.build(num_fields=3, vocab_size=10, embed_dim=4)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import paddle_tpu_torch\n"
            "from paddle_tpu_torch.distributed import sharded_table\n"
            "from paddle_tpu_torch.models import convert, deepfm\n"
            "from paddle_tpu_torch.ops import embed_cache, nn_ops\n"
            "from paddle_tpu_torch.ops.kernels import embed_cache as k\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (run on the card with `pytest -m gpu`)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cache_on_the_card_matches_the_single_table(cuda_device,
                                                    monkeypatch):
    """On the card the cache's installs and write-backs run the scatter
    and gather kernels (1 launch a call that installed or wrote back, for
    all three families, the flush's included) and train the losses of the same model on one
    table on the card (rtol 1e-4: the sparse gradient's duplicate rows
    summed in another order), from seeded weights."""
    from paddle_tpu_torch.ops.kernels import embed_cache as tek
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.manual_seed(0)
    state = deepfm.build(**CFG, device="cpu")[0].state_dict()
    runs = []
    for capacity in (None, 48):
        model, opt, _ = deepfm.build(**CFG, device=cuda_device)
        model.load_state_dict(state)
        cache = None
        if capacity:
            client = tst.in_process_fleet(64, 2)
            client.seed_from_value("deepfm_emb", state["emb"].numpy())
            cache = tec.enable_sharded_table(model.emb, opt, client,
                                             capacity)
            tek.reset_launches()
        losses = []
        for f in _feeds():
            ids = cache.translate(f["feat_ids"]) if cache else f["feat_ids"]
            opt.zero_grad(set_to_none=True)
            loss, _ = model(torch.from_numpy(ids).to(cuda_device),
                            torch.from_numpy(f["label"]).to(cuda_device))
            loss.backward()
            opt.step()
            losses.append(loss.item())
        if cache:
            cache.flush()
            torch.cuda.synchronize()
            assert tek.LAUNCHES == {"gather_rows": cache.writebacks,
                                    "scatter_rows": cache.installs}
            assert cache.writebacks > 10
        runs.append(losses)
    assert all(np.isfinite(runs[0]))
    np.testing.assert_allclose(runs[1], runs[0], rtol=LOSS_RTOL)
