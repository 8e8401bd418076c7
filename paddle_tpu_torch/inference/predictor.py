"""The predictor of the port (its own copy of the run half of
``paddle_tpu/inference/predictor.py``; reference: inference/api/
paddle_api.h PaddlePredictor, api/analysis_predictor.cc AnalysisPredictor
+ AnalysisConfig, CreatePaddlePredictor).

:class:`PaddlePredictor` loads a ``save_inference_model`` directory with
the port's ``fluid.io.load_inference_model`` into a scope of its own,
rewrites the program with :attr:`PaddlePredictor.ANALYSIS_PASSES`
(``fluid/ir_pass.py``; ``ir_optim``, on by default) and runs it with the
port's ``Executor``. The rewritten program is the JAX predictor's, op for
op, and its folded weights are bit-equal.

Port differences:

- **The device.** In the reference ``use_gpu`` and ``device_id`` are
  parity no-ops. Here they choose the place: ``CUDAPlace(device_id)`` by
  default (``use_gpu`` is True), which raises without a card;
  :meth:`AnalysisConfig.disable_gpu` is the one way to ask for
  ``CPUPlace()``.
- **The program label.** The program's desc is named after
  :meth:`PaddlePredictor._model_tag`, so an OOM inside ``run`` leaves its
  memdump and ``paddle_oom_events_total`` count under the model's name
  (the executor's except path, ``core/executor.py``).
- **Not ported: the AOT methods** (``save_compiled``, ``load_compiled``,
  ``has_aot_for``, ``aot_signatures``, the fallback counter
  ``paddle_serving_aot_fallback_total``). Eager PyTorch has no compiled
  executable to persist: ROADMAP A6.8 (capture) takes them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

import numpy as np

from paddle_tpu_torch.core.executor import CPUPlace, CUDAPlace, Executor
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.fluid import framework, io, ir_pass


@dataclass
class AnalysisConfig:
    """reference: api/paddle_analysis_config.h. ``use_gpu`` /
    ``device_id`` choose the place (module docstring); the memory-optim
    and TensorRT knobs are accepted and ignored, as in the reference."""

    model_dir: str = ""
    prog_file: str = ""
    params_file: str = ""
    # the serving metrics' `model` label and the program's OOM label;
    # defaults to the model directory's basename
    model_tag: str = ""
    # reference: switch_ir_optim -- run ANALYSIS_PASSES after loading
    ir_optim: bool = True
    use_gpu: bool = True
    device_id: int = 0
    enable_memory_optim_: bool = True
    tensorrt: dict = field(default_factory=dict)

    def enable_use_gpu(self, memory_pool_init_size_mb=0, device_id=0):
        self.use_gpu = True
        self.device_id = device_id

    def disable_gpu(self):
        """Run on the CPU: the only way a predictor leaves the card."""
        self.use_gpu = False

    def switch_ir_optim(self, x: bool = True):
        self.ir_optim = x

    def enable_memory_optim(self):
        self.enable_memory_optim_ = True

    def enable_tensorrt_engine(self, **kw):
        """reference: analysis_config TensorRT offload; recorded and
        ignored."""
        self.tensorrt = kw

    def place(self):
        return CUDAPlace(self.device_id) if self.use_gpu else CPUPlace()


class PaddlePredictor:
    """reference: paddle_api.h PaddlePredictor::Run over a loaded,
    rewritten program."""

    # the Analysis pipeline (reference: analysis_predictor.cc Analyzer +
    # ir_pass_manager), in the JAX predictor's order (``:83-101``): the
    # rnn and seq fusions before fc_fuse_pass, whose mul + add pattern
    # they start from
    ANALYSIS_PASSES = [
        "infer_clean_graph_pass",
        "is_test_pass",
        "conv_affine_channel_fuse_pass",
        "conv_bn_fuse_pass",            # InferenceTranspiler's fold
        "conv_elementwise_add2_act_fuse_pass",
        "conv_elementwise_add_act_fuse_pass",
        "conv_elementwise_add_fuse_pass",
        "embedding_fc_lstm_fuse_pass",
        "fc_lstm_fuse_pass",
        "fc_gru_fuse_pass",
        "seqconv_eltadd_relu_fuse_pass",
        "seqpool_concat_fuse_pass",
        "seq_concat_fc_fuse_pass",
        "transpose_flatten_concat_fuse_pass",
        "fc_fuse_pass",
    ]

    def __init__(self, config: AnalysisConfig):
        self._config = config
        self._scope = Scope()
        self._exe = Executor(config.place())
        program, feeds, fetches = io.load_inference_model(
            config.model_dir, self._exe,
            model_filename=config.prog_file or None,
            params_filename=config.params_file or None,
            scope=self._scope)
        if config.ir_optim:
            self._run_analysis_passes(program)
            # fresh op views over the rewritten block
            program = framework.Program(program.desc)
            program._is_test = True
        program.desc._obs_name = self._model_tag()
        self._program = program
        self._feed_names = feeds
        self._fetch_names = fetches

    @property
    def device(self):
        """The torch device the predictor runs on."""
        return self._exe.device

    def _run_analysis_passes(self, program):
        block = program.desc.global_block
        for name in self.ANALYSIS_PASSES:
            p = ir_pass.get_pass(name)
            p.scope = self._scope
            p(ir_pass.Graph(block))
        # the passes rewrote the block in place: a runner built for the
        # old version must never serve the new one
        program.desc.bump_version()

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def run(self, inputs) -> List[np.ndarray]:
        """``inputs``: a dict {feed name: array} or a list in feed
        order -> the fetches as numpy arrays."""
        if not isinstance(inputs, dict):
            inputs = dict(zip(self._feed_names, inputs))
        return self._exe.run(self._program, feed=inputs,
                             fetch_list=self._fetch_names,
                             scope=self._scope)

    # reference spelling
    __call__ = run

    def _model_tag(self) -> str:
        return (self._config.model_tag
                or os.path.basename(
                    os.path.normpath(self._config.model_dir or ""))
                or "default")


def create_paddle_predictor(config: AnalysisConfig) -> PaddlePredictor:
    """reference: CreatePaddlePredictor<AnalysisConfig>."""
    return PaddlePredictor(config)
