"""The PyTorch port's ``lookup_table`` (paddle_tpu_torch/ops/nn_ops.py)
against the JAX op's emitter (paddle_tpu/ops/nn_ops.py ``_lookup_table``)
and its gradients: the dense one through ``jax.vjp`` of the emitter, the
row-sparse one from the JAX package's embedding VJP
(paddle_tpu/ops/grad_ops.py ``_sparse_embedding_vjp``), summed into rows.

A gather copies values and a masked row is an exact zero, so the outputs
are compared exactly; the gradients add the rows of repeated ids (rtol
1e-6 for the order of those sums). Ids with a trailing dim of 1 lose it,
as in the JAX op; ``padding_idx`` zeroes those rows of the output and of
both gradients."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import nn_ops as tnn

# name: (ids shape, padding_idx)
CASES = {
    "n1": ((6, 1), None),
    "n1-padding": ((6, 1), 2),
    "bt1": ((2, 5, 1), None),
    "bt1-padding": ((2, 5, 1), 3),
    "bt": ((2, 5), 3),
}
V, D = 7, 3


@pytest.fixture(scope="module")
def jx():
    """(jax, the JAX op's emitter, the JAX package's sparse embedding
    VJP)."""
    jax = pytest.importorskip("jax")
    from paddle_tpu.ops import grad_ops
    from paddle_tpu.ops import nn_ops as jnn
    return jax, jnn._lookup_table, grad_ops._sparse_embedding_vjp


def _inputs(shape):
    rng = np.random.RandomState(3)
    w = rng.randn(V, D).astype(np.float32)
    ids = rng.randint(0, V, shape).astype(np.int64)
    ids.reshape(-1)[:3] = (2, 3, 2)        # every padding id of CASES, twice
    return w, ids


def test_smallest_inputs_of_the_fault():
    """The inputs the fault was found with: w = arange(12) [4, 3], ids
    [[1], [2]]: shape (2, 3), and with padding_idx 2 the second row 0."""
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[1], [2]])
    for sparse in (False, True):
        out = tnn.lookup_table(w, ids, sparse=sparse)
        assert out.shape == (2, 3)
        assert torch.equal(out, torch.tensor([[3., 4., 5.], [6., 7., 8.]]))
        padded = tnn.lookup_table(w, ids, sparse=sparse, padding_idx=2)
        assert torch.equal(padded, torch.tensor([[3., 4., 5.], [0., 0., 0.]]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_jax_op_and_its_gradients(jx, case):
    jax, emit, sparse_vjp = jx
    shape, pad = CASES[case]
    w, ids = _inputs(shape)
    attrs = {} if pad is None else {"padding_idx": pad}

    def jax_op(table):
        return emit(None, {"W": [table], "Ids": [jax.numpy.asarray(ids)]},
                    attrs)["Out"][0]
    want, vjp = jax.vjp(jax_op, jax.numpy.asarray(w))
    g = np.random.RandomState(4).randn(*want.shape).astype(np.float32)
    (want_dense,) = vjp(jax.numpy.asarray(g))
    rs = sparse_vjp(SimpleNamespace(type="lookup_table", attrs=attrs),
                    {"W": [jax.numpy.asarray(w)],
                     "Ids": [jax.numpy.asarray(ids)]},
                    {"Out": jax.numpy.asarray(g)})
    want_sparse = np.zeros((V, D), np.float32)
    np.add.at(want_sparse, np.asarray(rs.rows), np.asarray(rs.values))
    if pad is not None:
        assert not np.asarray(want).reshape(-1, D)[
            ids.reshape(-1) == pad].any()
    for sparse, want_grad in ((False, want_dense), (True, want_sparse)):
        table = torch.from_numpy(w).requires_grad_()
        out = tnn.lookup_table(table, torch.from_numpy(ids), sparse=sparse,
                               padding_idx=pad)
        assert out.shape == want.shape, (sparse, out.shape, want.shape)
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
        out.backward(torch.from_numpy(g))
        assert table.grad.is_sparse == sparse
        grad = table.grad.coalesce().to_dense() if sparse else table.grad
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                                   rtol=1e-6, atol=0)
