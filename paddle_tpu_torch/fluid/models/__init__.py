"""The bench builders of the port's program builder: ``build(...)``
appends a model's training (or test) program to the default programs,
with the JAX ``paddle_tpu/models`` builder's signature, defaults and
return ``(loss, fetches, feed_specs)``: ``mnist``, ``stacked_dynamic_lstm``,
``transformer``, the image classifiers ``smallnet``, ``alexnet``, ``vgg``,
``resnet``, ``se_resnext`` and ``googlenet``, ``deepfm`` and
``machine_translation`` (whose ``build(is_train=False)`` returns the beam
decoder's ``(sentence_ids, sentence_scores, feed_specs)``). The nn.Module
trainers of the same models are ``paddle_tpu_torch/models``."""
