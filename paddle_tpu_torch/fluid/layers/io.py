"""Data-input layers of the port (counterpart of ``paddle_tpu/fluid/
layers/io.py``; reference: python/paddle/fluid/layers/io.py data()). The
in-graph readers (``py_reader`` and the rest) are ROADMAP A6.10."""

from __future__ import annotations

from paddle_tpu_torch.fluid.layer_helper import LayerHelper


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, type=None):
    """reference: layers/io.py data() — declares a feed target; the -1
    batch dim is bound by the feed."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = helper.main_program.global_block()
    if block.has_var(name):
        return block.var(name)
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, stop_gradient=stop_gradient)
