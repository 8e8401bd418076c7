"""The bench builders of the port's program builder: ``build(...)``
appends a model's training (or test) program to the default programs,
with the JAX ``paddle_tpu/models`` builder's signature, defaults and
return ``(loss, fetches, feed_specs)``. The nn.Module trainers of the same
models are ``paddle_tpu_torch/models``. The other builders (resnet and
the image classifiers, deepfm, machine_translation) are ROADMAP A6.4b."""
