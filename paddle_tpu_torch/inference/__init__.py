"""Inference deployment of the port (counterpart of
``paddle_tpu/inference``): :class:`PaddlePredictor` over a saved model
with the analysis passes of ``fluid/ir_pass.py``, its
:class:`AnalysisConfig`, and the :class:`InferenceTranspiler`'s
batch-norm fold. ``export_stablehlo`` and the runner bundle
(``inference/export.py``) have no PyTorch counterpart yet (ROADMAP
A6.10).

    from paddle_tpu_torch.inference import AnalysisConfig, PaddlePredictor
    config = AnalysisConfig(model_dir=dirname)   # CUDAPlace(0)
    config.disable_gpu()                         # or the CPU, on request
    outs = PaddlePredictor(config).run({"img": x})
"""

from paddle_tpu_torch.inference.predictor import (AnalysisConfig,
                                                  PaddlePredictor,
                                                  create_paddle_predictor)
from paddle_tpu_torch.inference.transpiler import InferenceTranspiler

__all__ = ["AnalysisConfig", "InferenceTranspiler", "PaddlePredictor",
           "create_paddle_predictor"]
