"""Models of the port: ``transformer`` (the decoder-only LM of the serving
path and Transformer-base training), ``stacked_dynamic_lstm`` (the stacked
LSTM classifier's training), ``machine_translation`` (the attention-GRU
seq2seq model's training and beam decoding), ``deepfm`` (the CTR model,
trainable over a hot-rows cache of a sharded table), the image
classifiers of the reference's bench.py (``mnist``, ``smallnet``,
``alexnet``, ``vgg``, ``resnet``, ``se_resnext``, ``googlenet``, over
``classifier``) and ``convert`` (JAX scope weights into them)."""
